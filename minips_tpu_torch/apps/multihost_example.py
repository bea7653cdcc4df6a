"""Multi-host data plane — the port of
``minips_tpu/apps/multihost_example.py``, smoke-sized.

The JAX package joins every process into one JAX runtime and one global
mesh; the port joins them into one ``torch.distributed`` group
(``comm/cluster.py``) with one device per process, and the fused
pull->grad->push->update step (``tables/dense.py``) runs its collectives
over that group: NCCL where each process holds a card of its own, gloo
on the CPU. Each process feeds the rows (or the sequence slice) it
loaded.

Run under the launcher (which exports MINIPS_COORDINATOR + ranks):

    python -m minips_tpu_torch.launch --n 2 -- \\
        python -m minips_tpu_torch.apps.multihost_example --iters 30

Each rank prints ONE JSON line: losses, process/device counts, a
parameter fingerprint (gathered, so ranks can be compared), and the
result of a checkpoint save->restore drill in which every process writes
and reads only its own shards (``ckpt/orbax_backend.py`` on
``torch.distributed.checkpoint``).

``--mode bsp|ssp|asp`` runs the collective consistency axis instead
(``train/ssp_spmd.py``, ``train/cssp_ps.py``): per-process local steps
under the host-side staleness gate, the cross-process sync a collective.
A rank runs on ``cuda:{MINIPS_LOCAL_RANK mod device_count}``, or on the
CPU under ``MINIPS_FORCE_CPU=1`` / ``--device cpu``. Processes that share
a card sync through a gloo group (NCCL refuses two ranks on one device),
staging through host memory; ``--mode fused`` across processes needs one
card each (its tables live on the group's device, the CPU under gloo)
and refuses otherwise.

Single-process (no launcher) the same code runs on one device: that run
is the loss-parity oracle for the 2-process smoke.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from contextlib import contextmanager


class _Watchdog:
    """Fast failure detection for multi-process jobs (SURVEY §5.3): a
    peer death can leave the survivors BLOCKED inside a collective (NCCL
    waits on a dead peer), where the host thread cannot poll anything, so
    detection rides the HeartbeatMonitor's own thread via its
    ``on_failure`` callback (2 s timeout over the launcher's control
    bus): print the structured peer_failure event and ``os._exit(42)``,
    the same protocol as the sharded-PS apps."""

    def __init__(self, rank: int):
        from minips_tpu_torch.comm.heartbeat import HeartbeatMonitor
        from minips_tpu_torch.launch import init_from_env

        _, self.n, self.bus = init_from_env()
        self.monitor = None
        self._armed = True
        if self.bus is None:
            return

        def on_dead(peer: int) -> None:
            if self._armed:
                print(json.dumps({"rank": rank, "event": "peer_failure",
                                  "dead": [peer]}), flush=True)
                os._exit(42)

        self.monitor = HeartbeatMonitor(
            self.bus, peer_ids=list(range(self.n)), interval=0.2,
            timeout=2.0, on_failure=on_dead).start()

    def ready(self) -> None:
        """Handshake the bus once every handler of the run is registered
        (the trainer's clock gossip and union exchange): a frame that
        reaches a handler-less receive loop is dropped, and a lost first
        clock would hold a peer's gate until its timeout."""
        if self.bus is not None:
            self.bus.handshake(self.n)

    def disarm(self) -> None:
        """Call once training is complete, BEFORE the final barrier: a
        peer closing its bus after finishing must not read as a death."""
        self._armed = False

    def absorb_collective_failure(self, exc: BaseException) -> None:
        """A dead peer does not always leave survivors blocked: on gloo
        the broken TCP pair surfaces at once as a ``DistBackendError``
        (or a ``RuntimeError``) in whoever is in the collective, faster
        than the heartbeat timeout. Hold the rank long enough for the
        monitor to confirm and NAME the corpse (its on_failure callback
        prints peer_failure and exits 42); if no peer is confirmed dead
        the error was not a death: re-raise it."""
        if self.monitor is not None and self._armed:
            deadline = time.monotonic() + 3 * self.monitor.timeout + 2.0
            while time.monotonic() < deadline:
                self.monitor.check()  # on_failure -> print + exit 42
                time.sleep(0.1)
        raise exc

    @contextmanager
    def absorbing(self):
        """Run a training loop under the transport-error -> peer_failure
        translation (one spelling for every runner)."""
        try:
            yield
        except RuntimeError as e:  # DistBackendError is one
            self.absorb_collective_failure(e)

    def close(self) -> None:
        self.disarm()
        if self.monitor is not None:
            self.monitor.stop()
        if self.bus is not None:
            self.bus.close()


def _finish(rc: int) -> int:
    """Clean-exit join point: the coordinated group teardown
    (``cluster.shutdown``) AFTER the result line is printed."""
    from minips_tpu_torch.comm import cluster

    cluster.shutdown()
    return rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--mode", default="fused",
                    choices=["fused", "bsp", "ssp", "asp"],
                    help="fused: one group over every process, the BSP "
                         "data plane (the default); bsp/ssp/asp: "
                         "CollectiveSSP (train/ssp_spmd.py), per-process "
                         "local steps under the host-side staleness gate, "
                         "the cross-process sync a collective")
    ap.add_argument("--staleness", type=int, default=4,
                    help="SSP bound s for --mode ssp (bsp pins 0, "
                         "asp pins inf)")
    ap.add_argument("--sync-every", type=int, default=1,
                    help="collective merge every k local steps "
                         "(CollectiveSSP modes)")
    ap.add_argument("--sync-comm", default="float32",
                    choices=["float32", "bfloat16", "int8"],
                    help="CollectiveSSP modes: wire format of the delta "
                         "merge (bfloat16/int8 with an error-feedback "
                         "residual); lr/lm models only")
    ap.add_argument("--opt-sync", default="local",
                    choices=["local", "avg"],
                    help="CollectiveSSP modes, stateful updaters: 'local' "
                         "keeps each process's moments; 'avg' averages "
                         "float moments alongside the deltas")
    ap.add_argument("--slow-rank", type=int, default=-1)
    ap.add_argument("--slow-ms", type=int, default=0,
                    help="straggler injection: sleep this long before "
                         "each of --slow-rank's local steps")
    ap.add_argument("--jitter-ms", type=float, default=0.0,
                    help="TRANSIENT stall injection on every rank "
                         "(rank-seeded): sleep this long before a step "
                         "with --jitter-prob")
    ap.add_argument("--jitter-prob", type=float, default=0.0)
    ap.add_argument("--oracle-hosts", type=int, default=0,
                    help="single-process: SIMULATE this many processes "
                         "one after another (same merge schedule) — the "
                         "bitwise loss oracle for the real N-process "
                         "CollectiveSSP run")
    ap.add_argument("--model", default="lr", choices=["lr", "wd", "lm"],
                    help="lr: DenseTable LR (checkpoint drill supported); "
                         "wd: the flagship DeepFM fused step, hashed "
                         "SparseTables + deep tower; lm: ring-attention "
                         "SEQUENCE parallelism across the processes")
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--sp-attn", default="reference",
                    choices=["reference", "flash", "a2a", "a2a_flash"],
                    help="lm model: the sequence-parallel strategy across "
                         "the processes: ring (reference/flash) or "
                         "all-to-all (a2a/a2a_flash: heads widen to one "
                         "per process)")
    ap.add_argument("--num-slots", type=int, default=1 << 14)
    ap.add_argument("--batch", type=int, default=64,
                    help="GLOBAL batch size (split across processes)")
    ap.add_argument("--dim", type=int, default=None,
                    help="lr: feature dim (default 16); wd: embedding "
                         "dim (default 8)")
    ap.add_argument("--lr", type=float, default=None,
                    help="default: 0.3 (lr model) / 0.05 (wd)")
    ap.add_argument("--updater", default="adagrad",
                    choices=["sgd", "adagrad", "adam", "adam_bf16",
                             "adam8"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint-dir", default=None,
                    help="shared dir for the sharded checkpoint "
                         "save->restore drill (skipped when absent)")
    ap.add_argument("--save-at", type=int, default=0,
                    help="iteration AFTER which to save (0 = at the end)")
    ap.add_argument("--restore-from", type=int, default=0,
                    help="restore the step-N checkpoint before training "
                         "(the relaunch leg of the recovery drill)")
    ap.add_argument("--kill-at", type=int, default=0)
    ap.add_argument("--kill-rank", type=int, default=-1)
    ap.add_argument("--device", default=None,
                    help="this rank's device (default: its card; 'cpu', "
                         "as MINIPS_FORCE_CPU sets it)")
    args = ap.parse_args(argv)
    if os.environ.get("MINIPS_FORCE_CPU") and args.device is None:
        args.device = "cpu"
    if args.dim is None:  # per-model default: lr feature dim / wd emb dim
        args.dim = 16 if args.model == "lr" else 8
    if args.lr is None:
        args.lr = 0.3 if args.model == "lr" else 0.05
    if args.save_at > args.iters:
        ap.error(f"--save-at {args.save_at} exceeds --iters {args.iters}: "
                 "the restore drill would read a checkpoint never saved")
    if args.restore_from >= args.iters:
        ap.error(f"--restore-from {args.restore_from} must be < --iters "
                 f"{args.iters} (nothing left to train)")
    if args.opt_sync != "local" and args.mode == "fused":
        ap.error("--opt-sync is a CollectiveSSP-mode flag; the fused "
                 "path has ONE optimizer state (nothing to reconcile)")
    if args.sync_comm != "float32" and args.mode == "fused":
        ap.error("--sync-comm compresses the CollectiveSSP delta merge; "
                 "the fused path's wire format is make_step(comm=...)")

    import numpy as np
    import torch.distributed as dist

    from minips_tpu_torch.apps.common import multiproc_device
    from minips_tpu_torch.comm import cluster

    dev = multiproc_device(args.device)
    multi = cluster.initialize()
    args.device = dev
    rank = cluster.process_index()
    nprocs = cluster.process_count()
    watchdog = _Watchdog(rank)

    if args.mode != "fused":
        # the staleness axis over the flagship workloads: lr = dense
        # CollectiveSSP (+ the bitwise oracle), wd = row-sparse
        # CollectiveSSPPS over the DeepFM tables, lm = dense CollectiveSSP
        # over the transformer (per-process DP islands)
        if args.model == "lr":
            from minips_tpu_torch.train.ssp_spmd import run_ssp_spmd

            return _finish(run_ssp_spmd(args, rank, nprocs, multi, watchdog))
        if args.oracle_hosts:
            raise SystemExit("--oracle-hosts is the lr model's bitwise "
                             "oracle; wd/lm assert replica agreement "
                             "via fingerprints instead")
        if args.checkpoint_dir or args.save_at or args.restore_from \
                or args.kill_at:
            raise SystemExit("--checkpoint-dir/--save-at/--restore-from/"
                             "--kill-at are not wired for the wd/lm "
                             "CollectiveSSP paths; use --model lr for "
                             "the collective-SSP recovery drill")
        from minips_tpu_torch.train.cssp_ps import run_lm_cssp, run_wd_cssp

        if args.model == "wd":
            return _finish(run_wd_cssp(args, rank, nprocs, multi, watchdog))
        return _finish(run_lm_cssp(args, rank, nprocs, multi, watchdog))

    if args.oracle_hosts:
        raise SystemExit("--oracle-hosts simulates the CollectiveSSP "
                         "modes; the fused path's oracle is the same run "
                         "on one process")
    group = dist.group.WORLD if nprocs > 1 else None
    if group is not None and dev.type == "cuda" \
            and cluster.backend() != "nccl":
        raise SystemExit(
            "--mode fused across processes that share a card needs NCCL, "
            "one card per process (a gloo group keeps its tables on the "
            "CPU); run one process per card, or --device cpu")
    B, D = args.batch, args.dim
    if B % nprocs:
        raise SystemExit(f"--batch {B} must divide by {nprocs} processes")
    per = B // nprocs
    # every rank generates the identical GLOBAL batch stream and feeds its
    # own row slice: an n-process run and the single-process oracle train
    # on the same data and must produce the same losses
    rng = np.random.default_rng(args.seed)

    if args.model == "wd":
        return _finish(_run_wd(args, group, dev, rank, nprocs, per, multi,
                               rng, watchdog))
    if args.model == "lm":
        return _finish(_run_lm_sp(args, group, dev, rank, nprocs, multi,
                                  watchdog))

    from minips_tpu_torch.ckpt.orbax_backend import OrbaxCheckpointer
    from minips_tpu_torch.models import lr as lr_model
    from minips_tpu_torch.tables.dense import DenseTable

    dt = DenseTable(lr_model.init(D, device=dev), updater=args.updater,
                    lr=args.lr, device=dev, group=group)
    step = dt.make_step(lr_model.grad_fn_dense)
    w_true = rng.normal(size=D)

    def next_global():
        x = rng.normal(size=(B, D)).astype(np.float32)
        y = (x @ w_true > 0).astype(np.float32)
        return x, y

    ckpt_fp = None
    save_at = args.save_at or args.iters
    ckptr = None
    if args.checkpoint_dir:
        # every process writes only its own shards of the table
        ckptr = OrbaxCheckpointer(args.checkpoint_dir, {"dt": dt}, keep=0,
                                  group=group)

    start = 0
    if args.restore_from:  # relaunch leg of the recovery drill
        if ckptr is None:
            raise SystemExit("--restore-from needs --checkpoint-dir")
        ckptr.restore(args.restore_from)
        start = args.restore_from
        # replay the shared batch stream up to the restore point
        for _ in range(start):
            next_global()

    losses = []
    t0 = time.monotonic()
    with watchdog.absorbing():
        for i in range(start, args.iters):
            if args.kill_at and rank == args.kill_rank \
                    and i == args.kill_at:
                os._exit(137)
            x, y = next_global()
            batch = cluster.global_batch(
                {"x": x[rank * per:(rank + 1) * per],
                 "y": y[rank * per:(rank + 1) * per]}, dev)
            losses.append(float(dt.step_inplace(step, batch)))
            if ckptr is not None and i + 1 == save_at:
                ckptr.save(step=i + 1)
                ckpt_fp = float(cluster.host_copy(dt.params,
                                                  sharded=True).sum())

    # fingerprint + checkpoint roundtrip are collectives too
    with watchdog.absorbing():
        fp = float(cluster.host_copy(dt.params, sharded=True).sum())
        ckpt_ok = None
        if ckptr is not None and ckpt_fp is not None:
            # restore into a FRESH table and check it reproduces the state
            # that was saved (SURVEY.md §3.5, sharded state)
            dt2 = DenseTable(lr_model.init(D, device=dev),
                             updater=args.updater, lr=args.lr, device=dev,
                             group=group)
            OrbaxCheckpointer(args.checkpoint_dir, {"dt": dt2}, keep=0,
                              group=group).restore(save_at)
            ckpt_ok = bool(abs(float(cluster.host_copy(
                dt2.params, sharded=True).sum()) - ckpt_fp) < 1e-5)
        if ckptr is not None:
            ckptr.close()

    watchdog.disarm()  # peers closing their buses after finishing is fine
    cluster.barrier("multihost_done")  # reference Engine::Barrier
    print(json.dumps({
        "rank": rank, "event": "done",
        "wall_s": round(time.monotonic() - t0, 4),
        "multi": multi,
        "process_count": nprocs,
        "global_devices": nprocs,
        "local_devices": 1,
        "device": str(dev),
        "sync_backend": cluster.backend(),
        "loss_first": losses[0], "loss_last": losses[-1],
        "losses": [round(x, 8) for x in losses],
        "param_fingerprint": fp,
        "ckpt_roundtrip_ok": ckpt_ok,
        "resumed_from": start,
    }), flush=True)
    watchdog.close()
    return _finish(0)


def _run_lm_sp(args, group, dev, rank, nprocs, multi, watchdog):
    """Long-context x multi-process: the transformer LM with
    sequence parallelism across every process. Each process feeds its own
    sequence slice; the ring's K/V hops (or the all-to-all re-shard) cross
    the process boundary. Deterministic data (the same stream everywhere),
    so ranks must agree and a 1-process run is an exact oracle. With
    ``--sp-attn flash`` (or ``a2a_flash``) the attention is the
    hand-written flash kernels (K2-K4) on the card."""
    import numpy as np
    import torch

    from minips_tpu_torch.comm import cluster
    from minips_tpu_torch.models import transformer as tfm
    from minips_tpu_torch.tables.dense import DenseTable
    from minips_tpu_torch.train.cssp_ps import kernel_launches

    t0 = time.monotonic()
    n_shards = nprocs
    T = args.seq_len
    if T % n_shards:
        raise SystemExit(f"--seq-len {T} must divide by the {n_shards} "
                         "processes")
    heads = 2
    if args.sp_attn in ("a2a", "a2a_flash"):
        heads = n_shards  # all-to-all shards head groups: one per process
    # dim divides by heads and keeps head_dim >= 4
    model = dict(vocab=64, dim=heads * max(4, -(-32 // heads)),
                 heads=heads, depth=2, max_len=T)
    params = tfm.init(torch.Generator(device=dev).manual_seed(args.seed),
                      **model, device=dev)
    dt = DenseTable(params, updater=args.updater, lr=args.lr, name="lm_sp",
                    device=dev, group=group)
    T_local = T // n_shards
    sp_grad, shard_tokens = tfm.sp_train_wiring(model["heads"], T_local,
                                                group=group,
                                                attn_impl=args.sp_attn)
    step = dt.make_step(sp_grad)
    B = args.batch
    rng = np.random.default_rng(args.seed)
    lo, hi = rank * T_local, (rank + 1) * T_local
    losses = []
    t_loop0 = time.monotonic()
    with watchdog.absorbing():
        for i in range(args.iters):
            toks = rng.integers(0, model["vocab"], size=(B, T + 1))
            batch = shard_tokens(torch.as_tensor(
                toks.astype(np.int32)).to(dev))
            losses.append(float(dt.step_inplace(step, batch)))
    loop_s = time.monotonic() - t_loop0

    with watchdog.absorbing():  # the fingerprint gather too
        fp = float(cluster.host_copy(dt.params, sharded=True).sum())
    watchdog.disarm()
    cluster.barrier("multihost_lm_done")
    print(json.dumps({
        "rank": rank, "event": "done", "model": "lm",
        "wall_s": round(time.monotonic() - t0, 4),
        "loop_s": round(loop_s, 4),
        "multi": multi,
        "process_count": nprocs,
        "global_devices": n_shards,
        "local_devices": 1,
        "device": str(dev),
        "sync_backend": cluster.backend(),
        "seq_len": T, "seq_local": hi - lo,
        "sp_attn": args.sp_attn, "heads": heads,
        "loss_first": losses[0], "loss_last": losses[-1],
        "losses": [round(x, 8) for x in losses],
        "param_fingerprint": fp,
        "ckpt_roundtrip_ok": None,
        "kernel_launches": kernel_launches(),
    }), flush=True)
    watchdog.close()
    return 0


def _run_wd(args, group, dev, rank, nprocs, per, multi, rng, watchdog):
    """Flagship DeepFM across the processes: hashed SparseTables (wide +
    field embeddings) and the dense deep tower sharded over the group,
    one fused PSTrainStep whose row routing, gathers (K1 on the card) and
    gradient collectives cross the process boundary."""
    from minips_tpu_torch.apps.wide_deep_example import build
    from minips_tpu_torch.comm import cluster
    from minips_tpu_torch.core.config import Config, TableConfig, \
        TrainConfig
    from minips_tpu_torch.data import synthetic
    from minips_tpu_torch.train.cssp_ps import kernel_launches

    t0 = time.monotonic()
    cfg = Config(
        table=TableConfig(name="ctr", kind="sparse", updater=args.updater,
                          lr=args.lr, dim=args.dim,
                          num_slots=args.num_slots),
        train=TrainConfig(batch_size=args.batch, num_iters=args.iters),
    )
    ps, (wide_t, emb_t, deep_t) = build(cfg, use_fm=True, seed=args.seed,
                                        device=dev, group=group)
    # ONE dataset (one ground truth), identical on every rank; batches are
    # sampled from it with a shared stream and each rank feeds its slice
    data = synthetic.criteo_like(8192, seed=args.seed)
    losses = []
    with watchdog.absorbing():
        for i in range(args.iters):
            sel = rng.integers(0, data["y"].shape[0], size=args.batch)
            lo, hi = rank * per, (rank + 1) * per
            batch = cluster.global_batch(
                {k: v[sel][lo:hi] for k, v in data.items()}, dev)
            losses.append(float(ps(batch)))

    with watchdog.absorbing():  # the fingerprint gathers too
        fp = float(cluster.host_copy(emb_t.emb, sharded=True).sum()) \
            + float(cluster.host_copy(deep_t.params, sharded=True).sum())
    watchdog.disarm()
    cluster.barrier("multihost_wd_done")
    print(json.dumps({
        "rank": rank, "event": "done", "model": "wd",
        "wall_s": round(time.monotonic() - t0, 4),
        "multi": multi,
        "process_count": nprocs,
        "global_devices": nprocs,
        "local_devices": 1,
        "device": str(dev),
        "sync_backend": cluster.backend(),
        "loss_first": losses[0], "loss_last": losses[-1],
        "losses": [round(x, 8) for x in losses],
        "param_fingerprint": fp,
        "ckpt_roundtrip_ok": None,
        "emb_slots": int(args.num_slots),
        "kernel_launches": kernel_launches(),
    }), flush=True)
    watchdog.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
