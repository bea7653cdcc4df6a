"""Sharded multi-process PS — the port of
``minips_tpu/apps/sharded_ps_example.py``, the distributed smoke workload
for the key-range-sharded server (``train/sharded_ps.py``).

Every process owns a contiguous ROW RANGE of the table (the reference's
server-per-node topology, SURVEY.md §1 L2): pushes route per-owner key
slices point-to-point, the owner applies the SGD/Adagrad/Adam updater
server-side in numpy, and pulls fetch rows from owners. Consistency is
BSP/SSP/ASP through the owner-side staleness gate. Each rank's gradient
is taken by autograd on its device: ``--device`` when given (``cpu``
under ``MINIPS_FORCE_CPU``), else ``cuda:{MINIPS_LOCAL_RANK mod
device_count}``.

Two models:
- ``--model dense``: logistic regression on dense features; the weight
  vector is a dim-1-per-row table pulled whole (range fast path).
- ``--model sparse``: RCV1-shaped sparse LR — the per-key PS workload;
  only the batch's touched rows ride the wire.

Elastic membership (``MINIPS_ELASTIC``: ``--join-at``, ``--drain-at``,
SIGTERM, the standby loop), the coordinator-lease fence drill
(``--coord-plan-at``) and the pull storm (``--storm-*``, the load the
serving plane's admission sheds and the autoscaler watches) run as in the
JAX app. Every rank, a standby included, warms its card before the
heartbeat monitor starts (``apps/common.py`` ``multiproc_device``), so a
standby's first step after admission finds its context ready.

Run under the launcher:
    MINIPS_FORCE_CPU=1 python -m minips_tpu_torch.launch --n 3 -- \\
        python -m minips_tpu_torch.apps.sharded_ps_example --iters 40 \\
        --mode ssp

Each rank prints ONE JSON line (smoke/bench protocol) with loss, wire and
memory accounting, gate stats, and post-finalize parameter fingerprints the
tests assert replica agreement on.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", choices=["dense", "sparse"], default="dense")
    ap.add_argument("--iters", type=int, default=40)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--dim", type=int, default=None,
                    help="dense: feature dim (default 64); sparse: "
                         "key-space size, rounded up to a power of two "
                         "(default 2^14)")
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--updater", choices=["sgd", "adagrad", "adam"],
                    default="sgd")
    ap.add_argument("--mode", choices=["bsp", "ssp", "asp"], default="ssp")
    ap.add_argument("--staleness", type=int, default=2)
    ap.add_argument("--slow-rank", type=int, default=-1)
    ap.add_argument("--slow-ms", type=float, default=0.0)
    ap.add_argument("--jitter-ms", type=float, default=0.0,
                    help="transient-stall injection (every rank, random "
                         "--jitter-prob fraction of steps, rank-seeded) — "
                         "the regime where SSP beats BSP wall-clock; used "
                         "by bench_ssp.py --sharded")
    ap.add_argument("--jitter-prob", type=float, default=0.2)
    ap.add_argument("--kill-at", type=int, default=0)
    ap.add_argument("--kill-rank", type=int, default=-1)
    ap.add_argument("--join-at", type=int, default=None,
                    help="elastic membership (MINIPS_ELASTIC with this "
                         "rank standby): announce the join once the "
                         "live fleet's clock reaches this step "
                         "(default: announce immediately)")
    ap.add_argument("--drain-at", type=int, default=0,
                    help="elastic membership: --drain-rank initiates a "
                         "graceful leave at this iteration (SIGTERM "
                         "and the mbDr control frame trigger the same "
                         "path)")
    ap.add_argument("--drain-rank", type=int, default=-1)
    ap.add_argument("--coord-plan-at", type=int, default=0,
                    help="at step N the rank that BELIEVES it holds the "
                         "coordinator lease issues one no-op epoch-bump "
                         "plan (same overlay, epoch+1) — deterministic "
                         "coordinator-broadcast noise for the partition "
                         "fence drill: a plan issued inside a cut "
                         "window is journaled, recovered post-heal, and "
                         "must then be FENCED by term at every receiver "
                         "(0 = off)")
    ap.add_argument("--own-keys-rank", type=int, default=-1,
                    help="this rank draws its batch keys from its OWN "
                         "shard only (sparse model) — zero remote pull "
                         "legs, so a partitioned coordinator wedges at "
                         "its GATE (s boundaries late) instead of in "
                         "the first cut pull: the partition drill's "
                         "way of keeping the minority holder ticking "
                         "long enough to issue its stale plan")
    ap.add_argument("--storm-from", type=int, default=0,
                    help="pull-storm window start (sparse model only): "
                         "every rank issues --storm-pulls extra "
                         "read-only pulls of a fixed hot key range per "
                         "step in [from, until) — the admission-shed "
                         "load the closed-loop autoscaler "
                         "(MINIPS_AUTOSCALE) watches")
    ap.add_argument("--storm-until", type=int, default=0,
                    help="pull-storm window end (0 = no storm)")
    ap.add_argument("--storm-pulls", type=int, default=4,
                    help="extra hot-range pull batches per step inside "
                         "the storm window")
    ap.add_argument("--storm-keys", type=int, default=64,
                    help="keys per storm pull batch (a contiguous hot "
                         "range in the SECOND shard, so the hot owner "
                         "survives coordinator-kill drills)")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="per-rank shard checkpoints under "
                         "<dir>/rank<r>/; on start, ranks negotiate the "
                         "newest step ALL of them hold and resume there")
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device of the gradient step (default: "
                         "cuda:{MINIPS_LOCAL_RANK mod device_count}; "
                         "'cpu', as MINIPS_FORCE_CPU sets it)")
    from minips_tpu_torch.apps.common import add_wire_flags

    add_wire_flags(ap)
    args = ap.parse_args(argv)
    if os.environ.get("MINIPS_FORCE_CPU") and args.device is None:
        args.device = "cpu"

    import numpy as np
    import torch

    from minips_tpu_torch.apps.common import (init_multiproc,
                                              multiproc_device,
                                              run_multiproc_body,
                                              shard_checkpointing,
                                              table_wire_kwargs)
    from minips_tpu_torch.data import synthetic
    from minips_tpu_torch.models import lr as lr_model
    from minips_tpu_torch.tables.sparse import next_pow2
    from minips_tpu_torch.train.sharded_ps import (ShardedPSTrainer,
                                                   ShardedTable,
                                                   table_state_bytes)
    from minips_tpu_torch.utils.metrics import wire_record

    dev = multiproc_device(args.device)
    rank, nprocs, bus, monitor, staleness = init_multiproc(
        args.mode, args.staleness)

    sparse = args.model == "sparse"
    if sparse:
        num_rows = next_pow2(args.dim) if args.dim else 1 << 14
        data = synthetic.classification_sparse(
            n=args.batch * 8, dim=num_rows, seed=100 + rank)
    else:
        dim = args.dim if args.dim else 64
        num_rows = dim + 1  # weights + bias row
        data = synthetic.classification_dense(
            n=args.batch * 8, dim=dim, seed=100 + rank)

    table = ShardedTable("w", num_rows, 1, bus, rank, nprocs,
                         updater=args.updater, lr=args.lr,
                         monitor=monitor, pull_timeout=20.0,
                         async_push=(args.overlap and
                                     args.overlap_legs != "pull"),
                         **table_wire_kwargs(args))
    trainer = ShardedPSTrainer({"w": table}, bus, nprocs,
                               staleness=staleness, gate_timeout=30.0,
                               monitor=monitor)
    # elastic membership (MINIPS_ELASTIC, balance/membership.py): bind
    # the death path's checkpoint dir and the preemption signal before
    # any traffic — SIGTERM and the mbDr control frame both drain
    mb = trainer.membership
    if mb is not None:
        if mb.standby and args.model == "dense":
            # dense pull_all assembles whole shards from LIVE ranks: a
            # standby's home range is covered only once the bootstrap
            # plan lands, and the dense loop reads before the first
            # tick — refuse loudly instead of assembling torn rows
            print(json.dumps({
                "rank": rank, "event": "error",
                "err": "MINIPS_ELASTIC with standby ranks requires "
                       "--model sparse (dense pull_all reads before "
                       "the bootstrap migration lands)"}), flush=True)
            return 2
        import signal as _signal

        mb.bind_checkpoint(args.checkpoint_dir)
        _signal.signal(_signal.SIGTERM,
                       lambda *_a: mb.begin_drain())
    # shard checkpoint/resume (reference Dump/Load, SURVEY.md §3.5): the
    # whole negotiate→prune→restore→rendezvous protocol lives in
    # apps.common.shard_checkpointing, shared with the flagship W&D app
    resume = shard_checkpointing(bus, nprocs, args.checkpoint_dir, rank)
    bus.handshake(nprocs)  # after ALL handlers are registered
    start_iter, save_hook = resume({"w": table, "trainer": trainer},
                                   args.checkpoint_every)
    if mb is not None and mb.i_am_standby:
        # standby rank: serve (bus threads) and adopt plans until the
        # fleet admits me; train from the catch-up clock it hands over.
        # A pre-admission unrecoverable verdict exits with the same
        # structured peer_failure/42 protocol as the training body
        from minips_tpu_torch.consistency.gate import PeerFailureError

        try:
            start_iter = mb.standby_loop(args.join_at)
        except PeerFailureError as e:
            print(json.dumps({"rank": rank, "event": "peer_failure",
                              "dead": sorted(e.dead),
                              "at_clock": trainer.clock}), flush=True)
            return 42
        if start_iter < 0:
            # the fleet finished calm without ever needing me (mbEnd):
            # a standby that was never admitted exits clean, rc 0
            print(json.dumps({"rank": rank, "event": "standby_unused",
                              "elastic_spec":
                                  os.environ.get("MINIPS_ELASTIC")
                                  or None}), flush=True)
            monitor.stop()
            bus.close()
            return 0

    def on_dev(x):
        return torch.from_numpy(np.asarray(x)).to(dev)

    def grads_sparse(w_rows, batch):
        w_rows.requires_grad_()
        loss = lr_model.loss_sparse(w_rows, batch)
        return loss.detach(), torch.autograd.grad(loss, w_rows)[0]

    def grads_dense(vec, batch):
        vec.requires_grad_()
        loss = lr_model.loss_dense({"w": vec[:-1, 0], "b": vec[-1, 0]},
                                   batch)
        return loss.detach(), torch.autograd.grad(loss, vec)[0]

    storm_keys = None
    if args.storm_until:
        if not sparse:
            print(json.dumps({
                "rank": rank, "event": "error",
                "err": "--storm-until requires --model sparse (the "
                       "storm is per-key pull load)"}), flush=True)
            return 2
        # the hot range sits in the SECOND shard: coordinator-kill
        # drills SIGKILL rank 0, and a hot range on the corpse would
        # measure restore latency, not autoscaling. A table too small
        # to hold the range in shard 1 refuses loudly — silently
        # landing it in shard 0 would break exactly that guarantee
        shard = -(-num_rows // nprocs)
        if shard + args.storm_keys > num_rows:
            print(json.dumps({
                "rank": rank, "event": "error",
                "err": f"--storm-keys {args.storm_keys} does not fit "
                       f"in the second shard (rows {num_rows}, shard "
                       f"{shard}) — grow --dim or shrink the storm "
                       "range (it must avoid rank 0, the "
                       "coordinator-kill target)"}), flush=True)
            return 2
        storm_keys = shard + np.arange(args.storm_keys, dtype=np.int64)

    own_keys = None
    if args.own_keys_rank == rank:
        if not sparse or (args.overlap and args.overlap_legs != "push"):
            print(json.dumps({
                "rank": rank, "event": "error",
                "err": "--own-keys-rank requires --model sparse without "
                       "pull overlap (the localization rewrites the "
                       "plain pull path's keys)"}), flush=True)
            return 2
        shard = -(-num_rows // nprocs)
        lo = rank * shard
        own_keys = (lo, max(1, min(shard, num_rows - lo)))

    losses = []
    # resumed runs reseed on (rank, start): batch sampling is with-
    # replacement, so resume is convergence-equivalent, not bit-exact
    rng = np.random.default_rng((rank, start_iter))
    jitter_rng = np.random.default_rng(1000 + rank)
    final = None
    t0 = time.monotonic()

    def body():
        nonlocal final
        # --overlap double buffer (sparse path): [sel, keys, PullFuture]
        # for the NEXT batch, issued before this batch computes. Draw
        # order is unchanged — draws stay sequential, each iteration
        # consumes its own draw — so loss streams are comparable across
        # the overlap on/off arms.
        ahead: list = [None, None, None]

        def draw_sel():
            return rng.integers(0, data["y"].shape[0], size=args.batch)

        for i in range(start_iter, args.iters):
            if args.kill_at and rank == args.kill_rank and i == args.kill_at:
                os._exit(137)
            if mb is not None and (mb.draining or (
                    args.drain_at and rank == args.drain_rank
                    and i == args.drain_at)):
                # graceful leave: stop training, hand my blocks to
                # survivors under the fence, exit clean (rc 0) — the
                # done line below says "drained", never "done"
                if ahead[2] is not None:
                    ahead[2].cancel()
                mb.leave()
                return
            if sparse:
                if args.overlap and args.overlap_legs != "push":
                    if ahead[2] is None:  # first batch: nothing in flight
                        s0 = draw_sel()
                        k0 = data["idx"][s0].reshape(-1)
                        ahead[:] = [s0, k0,
                                    table.prefetch_pull(k0, clock_ahead=0)]
                    sel, keys, fut = ahead
                    s1 = draw_sel()  # issue batch t+1 before t computes:
                    k1 = data["idx"][s1].reshape(-1)
                    ahead[:] = [s1, k1, table.prefetch_pull(k1)]
                    rows = fut.wait().reshape(args.batch, -1, 1)
                else:
                    sel = draw_sel()
                    keys = data["idx"][sel].reshape(-1)
                    if own_keys is not None:
                        # drill localization (--own-keys-rank): fold
                        # every key into my own shard — zero remote
                        # pull legs, identical wire shape otherwise
                        keys = own_keys[0] + (keys % own_keys[1])
                    rows = table.pull(keys).reshape(args.batch, -1, 1)
                batch = {k: on_dev(data[k][sel])
                         for k in ("val", "mask", "y")}
                loss, g = grads_sparse(on_dev(rows), batch)
                # scale 1/nprocs: N workers push per clock; keeps the
                # effective per-clock step comparable across world sizes
                table.push(keys, g.cpu().numpy().reshape(-1, 1) / nprocs)
            else:
                # dense path: pull_all has no prefetch twin (the whole
                # vector is the working set); --overlap still buys the
                # async push-leg below
                sel = draw_sel()
                batch = {"x": on_dev(data["x"][sel]),
                         "y": on_dev(data["y"][sel])}
                vec = table.pull_all()
                loss, g = grads_dense(on_dev(vec), batch)
                table.push_dense(g.cpu().numpy() / nprocs)
            if storm_keys is not None \
                    and args.storm_from <= i < args.storm_until:
                # the read storm: extra hot-range pulls on top of the
                # training traffic — with MINIPS_SERVE admission armed
                # the hot owner sheds/backpressures these (explicit
                # refusal + bounded retry, never silence), and those
                # shed counters are the autoscaler's scale-up signal
                for _ in range(args.storm_pulls):
                    table.pull(storm_keys)
            losses.append(float(loss))
            trainer.tick()
            if (args.coord_plan_at and i == args.coord_plan_at
                    and mb is not None and mb.coord == mb.rank
                    and not mb.busy):
                # fence-drill plan noise (see the flag help): issued
                # POST-tick on the push-driving thread, the same
                # contract as the planner's own issuance point
                rb = trainer.rebalancer
                for name, t in trainer.tables.items():
                    # one atomic snapshot: epoch AND overlay from the
                    # same table() read — re-reading router.epoch could
                    # straddle a concurrent adoption and stamp a stale
                    # overlay with a fresh epoch
                    ep, ov = t.router.table()
                    rb.issue_plan(name, ep + 1, dict(ov))
            save_hook(i)
            if rank == args.slow_rank and args.slow_ms > 0:
                time.sleep(args.slow_ms / 1000.0)
            if args.jitter_ms > 0 \
                    and jitter_rng.random() < args.jitter_prob:
                time.sleep(args.jitter_ms / 1000.0)
        if ahead[2] is not None:
            ahead[2].cancel()  # dangling last prefetch: never consumed
        trainer.finalize(timeout=20.0)
        # inside the guarded body: a peer that already printed and closed
        # its bus can look heartbeat-dead while we assemble — that must
        # surface as the structured peer_failure event, not a traceback
        final = table.pull_all()
        # finalize quiesced pushes only; peers' pull_alls still need my
        # server — rendezvous before anyone closes
        trainer.shutdown_barrier(timeout=10.0)

    code = run_multiproc_body(rank, trainer, body)
    drained = mb is not None and rank in mb.left
    if code == 0 and drained:
        # the graceful-leave exit line: rc 0, zero restored state, no
        # finalize (the survivors quiesce among themselves)
        print(json.dumps({
            "rank": rank, "event": "drained",
            "device": str(dev),
            "wall_s": round(time.monotonic() - t0, 4),
            "loss_last": (float(np.mean(losses[-5:]))
                          if losses else None),
            "clock": trainer.clock,
            # a leaver exiting with resident residual rows would be
            # silently-lost gradient mass: the drain drill asserts 0
            "ef": trainer.ef_stats(),
            "elastic_spec": os.environ.get("MINIPS_ELASTIC") or None,
            "membership": trainer.membership_stats(),
            "autoscale": trainer.autoscale_stats(),
            # sender-side staging evidence: the leaver is the drain's
            # SOURCE, so its rebalance peak (one-shot p2p ship) and
            # reshard round/slice counters + per-round peak (planned
            # mode) are the numbers the live-wire memory leg compares
            # against the cap
            "rebalance": trainer.rebalance_stats(),
            "reshard": trainer.reshard_stats(),
            "frames_dropped": trainer.frames_dropped,
            "wire_frames_lost": trainer.wire_frames_lost,
            "resumed_from": start_iter,
        }), flush=True)
    elif code == 0:
        table_bytes = table_state_bytes(num_rows, 1, args.updater)
        print(json.dumps({
            "rank": rank, "event": "done",
            # wire-knob echo: sweeps assert the negotiated config so a
            # flag-plumbing regression can't publish a mislabeled number
            # (the RESOLVED value: --push-comm default None defers to
            # $MINIPS_PUSH_COMM, and the echo must name what ran)
            "push_comm": table.push_comm,
            "pull_wire": args.pull_wire,
            "overlap": bool(args.overlap),
            "overlap_legs": args.overlap_legs if args.overlap else None,
            "cache_bytes": args.cache_bytes,
            "pull_dedup": bool(args.pull_dedup),
            # chaos/reliable echo (env-configured, launcher-inherited):
            # the e2e drill asserts the arm it thinks it ran really ran
            "chaos_spec": os.environ.get("MINIPS_CHAOS") or None,
            "reliable_on": os.environ.get("MINIPS_RELIABLE", "")
            not in ("", "0"),
            # rebalancer echo (env-configured): wire_record below
            # carries the serve/rebalance counter blocks themselves
            "rebalance_spec": os.environ.get("MINIPS_REBALANCE") or None,
            # elastic membership echo + chaos-kill spec: the drills
            # assert the arm they think they ran really ran
            "elastic_spec": os.environ.get("MINIPS_ELASTIC") or None,
            "autoscale_spec": os.environ.get("MINIPS_AUTOSCALE") or None,
            "chaos_kill_spec": os.environ.get("MINIPS_CHAOS_KILL")
            or None,
            # hier-tree echo (wire_record carries its counters)
            "hier_spec": os.environ.get("MINIPS_HIER") or None,
            "device": str(dev),
            "wall_s": round(time.monotonic() - t0, 4),
            "loss_first": losses[0] if losses else None,
            "loss_last": float(np.mean(losses[-5:])) if losses else None,
            "gate_waits": trainer.gate_waits,
            "max_skew_seen": trainer.max_skew_seen,
            **wire_record(trainer),
            "local_bytes": trainer.local_bytes(),
            "table_bytes": int(table_bytes),
            "param_sum": float(final.sum()),
            "param_norm": float(np.linalg.norm(final)),
            "clock": trainer.clock,
            "resumed_from": start_iter,
        }), flush=True)

    monitor.stop()
    bus.close()
    return code


if __name__ == "__main__":
    sys.exit(main())
