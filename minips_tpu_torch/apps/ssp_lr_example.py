"""Distributed SSP training — the port of
``minips_tpu/apps/ssp_lr_example.py``, the multi-process smoke workload.

``--model lr`` (default) is logistic regression on dense features;
``--model mlp`` is the 3-layer MLP on MNIST-shaped data, BASELINE.json's
config 2 ("3-layer MLP on MNIST, SSP staleness = 4"), through the same
``SSPTrainer`` (model-agnostic: any ``(params, batch) -> (params,
loss)`` step). Run under the launcher:

    python -m minips_tpu_torch.launch --n 3 -- \\
        python -m minips_tpu_torch.apps.ssp_lr_example --iters 60 \\
        --mode ssp --staleness 2

Each process trains on its own data shard through ``SSPTrainer`` (delta
gossip + clock gate over the bus), then prints ONE JSON line: loss fell,
the staleness bound held, replicas agree after finalize. A rank's step
runs on ``cuda:{MINIPS_LOCAL_RANK mod device_count}``, or on the CPU
under ``MINIPS_FORCE_CPU=1`` / ``--device cpu``
(``apps/common.py:multiproc_device``).

Fault drill (SURVEY.md §5.3): ``--kill-at K --kill-rank R`` makes rank R
die abruptly at step K; survivors detect it via heartbeat and exit 42;
the job's launcher relaunches everyone with ``--resume`` to restore the latest
checkpoint and finish.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", choices=["lr", "mlp"], default="lr",
                    help="lr: logistic regression; mlp: 3-layer MLP on "
                         "MNIST-shaped data (BASELINE.json config 2)")
    ap.add_argument("--iters", type=int, default=60)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--dim", type=int, default=None,
                    help="lr: feature dim (default 64); mlp: fixed at 784 "
                         "(MNIST-shaped), passing --dim is an error")
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--mode", choices=["bsp", "ssp", "asp"], default="ssp")
    ap.add_argument("--staleness", type=int, default=2)
    ap.add_argument("--push-every", type=int, default=1)
    ap.add_argument("--compress", type=float, default=1.0,
                    help="fraction of delta entries per push (<1 = top-k "
                         "sparsification with error feedback)")
    ap.add_argument("--slow-rank", type=int, default=-1,
                    help="rank to artificially slow (straggler injection)")
    ap.add_argument("--slow-ms", type=float, default=0.0)
    ap.add_argument("--jitter-ms", type=float, default=0.0,
                    help="transient-stall injection: every rank sleeps "
                         "this long on a random --jitter-prob fraction of "
                         "its steps (rank-seeded)")
    ap.add_argument("--jitter-prob", type=float, default=0.2)
    ap.add_argument("--data-file", default=None,
                    help="libsvm file fed via DYNAMIC block assignment "
                         "(rank 0 = BlockMaster): fast ranks take more "
                         "blocks, a dead rank's blocks re-queue to "
                         "survivors. --model lr only.")
    ap.add_argument("--block-lines", type=int, default=200,
                    help="lines per assigned block (--data-file mode)")
    ap.add_argument("--max-nnz", type=int, default=32,
                    help="--data-file mode: padded features per row; rows "
                         "with more index:value pairs are TRUNCATED to "
                         "this many")
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--kill-at", type=int, default=0,
                    help="die abruptly at this step (fault injection)")
    ap.add_argument("--kill-rank", type=int, default=-1)
    ap.add_argument("--device", default=None,
                    help="the step's device (default: this rank's card; "
                         "'cpu', as MINIPS_FORCE_CPU sets it)")
    args = ap.parse_args(argv)
    if os.environ.get("MINIPS_FORCE_CPU") and args.device is None:
        args.device = "cpu"

    import numpy as np
    import torch

    from minips_tpu_torch.apps.common import multiproc_device
    from minips_tpu_torch.comm.heartbeat import HeartbeatMonitor
    from minips_tpu_torch.data import synthetic
    from minips_tpu_torch.launch import init_from_env
    from minips_tpu_torch.train.ssp_trainer import PeerFailureError, \
        SSPTrainer
    from minips_tpu_torch.utils.tree import tree_leaves, tree_rebuild

    dev = multiproc_device(args.device)
    rank, nprocs, bus = init_from_env()
    staleness = {"bsp": 0, "ssp": args.staleness,
                 "asp": float("inf")}[args.mode]

    # --- dynamic block assignment (--data-file): rank 0 coordinates
    master = client = None
    requeued = {"n": 0}
    if args.data_file:
        if args.model != "lr":
            ap.error("--data-file implies --model lr")
        from minips_tpu_torch.data import blocks as blk

        if bus is None:  # single-process: plain list, no coordination
            client = blk.split_file_lines(args.data_file, args.block_lines)
        else:
            if rank == 0:
                master = blk.BlockMaster(
                    bus, blk.split_file_lines(args.data_file,
                                              args.block_lines))
            client = blk.BlockClient(bus, local_master=master)

    # my shard: different seed per rank = disjoint data (SURVEY.md §2.2 DP)
    if args.model == "mlp":
        if args.dim is not None:
            ap.error("--dim applies to --model lr only (mlp input is "
                     "fixed at 784, MNIST-shaped)")
        from minips_tpu_torch.models import mlp as mlp_model

        data = synthetic.mnist_like(n=args.batch * 8, seed=100 + rank)
        params = mlp_model.init(torch.Generator().manual_seed(0),
                                sizes=(784, 256, 128, 10), device=dev)
        grad_fn = mlp_model.grad_fn
    else:
        from minips_tpu_torch.models import lr as lr_model

        # file mode defaults to the a9a feature space (123, SURVEY.md §7.3)
        dim = args.dim if args.dim is not None else (
            123 if args.data_file else 64)
        data = None if args.data_file else synthetic.classification_dense(
            n=args.batch * 8, dim=dim, seed=100 + rank)
        params = lr_model.init(dim, device=dev)
        grad_fn = lr_model.grad_fn_dense

    def on_dev(batch):
        return {k: torch.as_tensor(np.asarray(v)).to(dev)
                for k, v in batch.items()}

    def local_step(p, batch):
        loss, g = grad_fn(p, on_dev(batch))
        new = [w - args.lr * gw / nprocs
               for w, gw in zip(tree_leaves(p), tree_leaves(g))]
        return tree_rebuild(p, iter(new)), loss

    monitor = None
    if bus is not None:
        on_fail = None
        if master is not None:
            def on_fail(pid):  # dead rank's blocks back to the survivors
                requeued["n"] += master.handle_failure(pid)
        monitor = HeartbeatMonitor(
            bus, peer_ids=list(range(nprocs)),
            interval=0.2, timeout=2.0, on_failure=on_fail).start()

    trainer = SSPTrainer(local_step, params, bus, nprocs,
                         staleness=staleness, push_every=args.push_every,
                         gate_timeout=30.0, monitor=monitor,
                         compress=args.compress) \
        if bus is not None else None
    if bus is not None:
        # AFTER all handlers (delta/clock/heartbeat) are registered: a
        # handler-less recv loop drops messages
        bus.handshake(nprocs)

    ckpt = None
    start_step = 0
    if args.checkpoint_dir and trainer is not None:
        from minips_tpu_torch.ckpt.orbax_backend import make_checkpointer

        ckpt = make_checkpointer(args.checkpoint_dir, {"ssp": trainer},
                                 keep=2)
        if args.resume:
            start_step = ckpt.restore()
            # every rank restores before any rank steps: a rank that
            # stepped first would find a peer still at clock 0 and read
            # the restart's gap as staleness (max_skew_seen)
            if not trainer.gossip.wait_global_min(start_step,
                                                  timeout=30.0):
                raise TimeoutError(f"peers never restored step "
                                   f"{start_step}")

    losses = []
    consumed = {"n": 0}
    rng = np.random.default_rng(rank)
    jitter_rng = np.random.default_rng(1000 + rank)
    code = 0
    t_loop0 = time.monotonic()

    def step_tail(i, loss):
        losses.append(loss)
        if rank == args.slow_rank and args.slow_ms > 0:
            time.sleep(args.slow_ms / 1000.0)
        if args.jitter_ms > 0 and jitter_rng.random() < args.jitter_prob:
            time.sleep(args.jitter_ms / 1000.0)
        if (ckpt is not None and rank == 0 and args.checkpoint_every
                and (i + 1) % args.checkpoint_every == 0):
            ckpt.save(step=i + 1)

    try:
        if args.data_file:
            # ---- dynamic block-driven loop: batches stream out of blocks
            # the master hands this rank; fast ranks naturally take more
            from minips_tpu_torch.data.blocks import (iter_block_batches,
                                                      read_block_bytes)
            from minips_tpu_torch.data.libsvm import (apply_one_based_shift,
                                                      densify,
                                                      detect_one_based,
                                                      parse_libsvm_block,
                                                      parse_libsvm_lines)

            # 1-based-vs-0-based is a WHOLE-FILE property: decided once
            # from the head
            with open(args.data_file, "rb") as f:
                one_based = detect_one_based(parse_libsvm_lines(
                    [ln for ln, _ in zip(f, range(1000))]))

            def counting(it):
                for b in it:
                    consumed["n"] += 1
                    yield b

            def parse_block(b):
                d = parse_libsvm_block(read_block_bytes(b),
                                       width=args.max_nnz)
                if one_based:
                    apply_one_based_shift(d)
                return densify(d, dim)

            i = start_step
            for batch in iter_block_batches(counting(client), parse_block,
                                            args.batch):
                if (args.kill_at and rank == args.kill_rank
                        and i == args.kill_at):
                    os._exit(137)
                if trainer is not None:
                    loss = trainer.step(batch)
                else:
                    params, loss = local_step(params, batch)
                    loss = float(loss)
                step_tail(i, loss)
                i += 1
                if i >= args.iters:
                    break
            if trainer is not None:
                # unequal per-rank step counts are the point of dynamic
                # assignment: a finished rank must never stall peers' gates
                trainer.retire()
        else:
            for i in range(start_step, args.iters):
                if (args.kill_at and rank == args.kill_rank
                        and i == args.kill_at):
                    os._exit(137)  # abrupt death: no close(), no flush
                sel = rng.integers(0, data["y"].shape[0], size=args.batch)
                batch = {"x": data["x"][sel], "y": data["y"][sel]}
                if trainer is not None:
                    loss = trainer.step(batch)
                else:  # single-process degenerate case
                    params, loss = local_step(params, batch)
                    loss = float(loss)
                step_tail(i, loss)
        if trainer is not None:
            trainer.finalize(timeout=20.0)
    except PeerFailureError as e:
        print(json.dumps({"rank": rank, "event": "peer_failure",
                          "dead": sorted(e.dead),
                          "at_clock": trainer.clock}), flush=True)
        code = 42
    except TimeoutError as e:
        print(json.dumps({"rank": rank, "event": "gate_timeout",
                          "err": str(e)}), flush=True)
        code = 43

    if code == 0 and trainer is not None:
        flat = trainer.flat.detach().cpu().numpy()
        print(json.dumps({
            "rank": rank, "event": "done",
            "wall_s": round(time.monotonic() - t_loop0, 4),
            "loss_first": losses[0] if losses else None,
            "loss_last": float(np.mean(losses[-5:])) if losses else None,
            "gate_waits": trainer.gate_waits,
            "max_skew_seen": trainer.max_skew_seen,
            "deltas_applied": trainer.deltas_applied,
            "bytes_pushed": trainer.bytes_pushed,
            "param_sum": float(flat.sum()),
            "param_norm": float(np.linalg.norm(flat)),
            "clock": trainer.clock,
            "blocks_consumed": consumed["n"],
            "blocks_requeued": requeued["n"],
            "blocks_remaining": (master.assigner.remaining
                                 if master is not None else None),
            "device": str(dev),
        }), flush=True)

    if monitor is not None:
        monitor.stop()
    if bus is not None:
        bus.close()
    return code


if __name__ == "__main__":
    sys.exit(main())
