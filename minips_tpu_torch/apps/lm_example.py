"""lm_example — the decoder-only LM app, the port of
``minips_tpu/apps/lm_example.py``. Layouts:

- ``--layout dp`` (the default): the whole LM in one ``DenseTable``,
  trained by its fused step on the device (``--device``, the card by
  default);
- ``--layout sp``: the batch replicated, the SEQUENCE sharded over the
  ranks: ring attention (``--attn reference|flash``: K2 on every ring
  step on the card) or all-to-all (``--attn a2a|a2a_flash``, heads
  divisible by the ranks), positions at each shard's global offset,
  through the same ``DenseTable`` fused step over the group;
- ``--layout tp``: a (data x model) mesh of ranks, ``--tp`` the model
  axis: the batch sharded over data, the block weights Megatron-cut over
  model;
- ``--layout pp``: the same mesh, the blocks GPipe-pipelined over model
  (``--tp`` stages, ``--microbatches`` in flight);
- ``--layout ep``: the MoE LM, the batch and the experts sharded over the
  ranks (``--experts``, ``--k_top``, ``--capacity`` per expert per source
  rank).

tp, pp and ep train each rank's shards with the port's own Adam
(``tables/updaters.py``) at ``--lr``, as the JAX app's tail trains with
``optax.adam``; after the backward each leaf's gradient is summed over
the ranks that hold it replicated while their batches differ (the data
axis), as shard_map's transpose sums it, and the loss is the data mean.
``run(cfg, args, metrics, group)`` runs one rank of a layout on a
``torch.distributed`` group (the default group, which ``make_groups``
splits for tp and pp; ``None`` is one device); the CLI spawns ``--ranks``
ranks (the apps' shared flag, ``apps/common.py``; for sp, tp, pp and ep 0
means one per visible card; with ``--device cpu``, gloo ranks on the CPU)
through ``parallel/mesh.py:run_ranks`` and prints rank 0's metrics.

The dp path has every flag of the JAX app's:

- ``--attn reference|flash`` (K2–K4 on the card), ``--accum``,
  ``--dtype`` (worker-math precision), ``--comm`` (the step's wire
  format);
- ``--updater adamw`` with ``--weight_decay`` on matrices only
  (``transformer.decay_mask``), ``--clip_norm``, ``--warmup_steps``
  (linear warm-up, then cosine decay to 10% of ``--lr``);
- ``--remat`` with ``--remat_mode full|attn|dots|hybrid|hybrid_qkv``,
  ``--head_chunk``, ``--dropout`` (per-step keys ride the batch);
- ``--dim/--depth/--heads/--kv_heads/--rope/--max_len/--seq_len``;
- ``--data_file`` (a byte-level LM over a file) in place of synthetic
  Markov sequences;
- ``--checkpoint_dir/--checkpoint_every/--resume`` (the native
  checkpointer; a completed run resumed again takes no step; under a
  group, dp and sp, rank 0 writes and every rank restores);
- ``--generate N`` (``--temperature``): after training, decode N tokens
  through the KV cache (``models/decode.py``) at the training precision.

The JAX app's refusals are kept flag by flag.

Usage: python -m minips_tpu_torch.apps.lm_example --num_iters 200
       python -m minips_tpu_torch.apps.lm_example --device cpu \\
           --num_iters 20 --remat --remat_mode dots --dropout 0.1 \\
           --generate 16
       python -m minips_tpu_torch.apps.lm_example --device cpu --ranks 2 \\
           --layout sp --attn flash --num_iters 20
"""

from __future__ import annotations

import functools

import torch

from minips_tpu_torch.apps.common import app_main, run_cli
from minips_tpu_torch.core.config import Config, TableConfig, TrainConfig
from minips_tpu_torch.data import synthetic
from minips_tpu_torch.data.loader import BatchIterator
from minips_tpu_torch.models import transformer as tfm
from minips_tpu_torch.parallel.mesh import (Group, all_reduce_sum,
                                            axis_index, make_groups, pmean,
                                            resolve_device, world)
from minips_tpu_torch.parallel.partition import shard_params
from minips_tpu_torch.tables.dense import DenseTable, ravel
from minips_tpu_torch.tables.updaters import (make_updater,
                                              warmup_cosine_decay_schedule)
from minips_tpu_torch.train.loop import TrainLoop
from minips_tpu_torch.utils.tree import tree_leaves, tree_rebuild

DEFAULT = Config(
    table=TableConfig(name="lm", kind="dense", updater="adam", lr=3e-3),
    train=TrainConfig(batch_size=32, num_iters=200),
)

MODEL = dict(vocab=256, dim=64, heads=4, depth=2, max_len=1024)
# the dropout keys' seed offset from --seed, as in the JAX app
DROPOUT_SEED_OFFSET = 71


def _flags(parser):
    parser.add_argument("--layout", default="dp",
                        choices=["dp", "sp", "tp", "pp", "ep"],
                        help="dp: batch sharded; sp: sequence sharded "
                             "(ring or all-to-all attention); tp: Megatron "
                             "tensor parallel; pp: GPipe pipeline; ep: "
                             "MoE-LM with experts sharded over the ranks")
    parser.add_argument("--experts", type=int, default=8,
                        help="ep layout: number of experts (must divide "
                             "by the rank count)")
    parser.add_argument("--k_top", type=int, default=1,
                        help="ep layout: experts per token")
    parser.add_argument("--capacity", type=int, default=0,
                        help="ep layout: slots per expert per source "
                             "rank (0 = 2x the even share)")
    parser.add_argument("--seq_len", type=int, default=128)
    parser.add_argument("--tp", type=int, default=2,
                        help="model-axis size for tp/pp layouts")
    parser.add_argument("--microbatches", type=int, default=4,
                        help="pp layout: microbatches in flight")
    parser.add_argument("--data_file", default=None,
                        help="train on this file's bytes (byte-level LM, "
                             "vocab 256) instead of synthetic data")
    # --checkpoint_dir / --checkpoint_every come from add_config_flags
    parser.add_argument("--resume", action="store_true",
                        help="restore the newest checkpoint before "
                             "training")
    parser.add_argument("--head_chunk", type=int, default=0,
                        help="sequence-chunked tied head + cross-entropy "
                             "(the [B,T,vocab] logits never exist); 0 = "
                             "plain head")
    parser.add_argument("--remat_mode", default="full",
                        choices=["full", "attn", "dots", "hybrid",
                                 "hybrid_qkv"],
                        help="with --remat: full = recompute whole blocks; "
                             "attn = save attention outputs; dots = save "
                             "matmul outputs; hybrid(_qkv) = save attention "
                             "outputs and the MLP hidden (and q/k/v)")
    parser.add_argument("--remat", action="store_true",
                        help="recompute block activations in the backward")
    parser.add_argument("--attn", default="reference",
                        choices=["reference", "flash", "a2a", "a2a_flash"],
                        help="reference: plain scores; flash: the fused "
                             "kernels (K2-K4 on the card; on sp, ring "
                             "flash attention); a2a and a2a_flash: "
                             "all-to-all sequence parallelism (sp only; "
                             "heads %% ranks == 0)")
    parser.add_argument("--accum", type=int, default=1,
                        help="gradient-accumulation microbatches per step")
    parser.add_argument("--dim", type=int, default=None,
                        help=f"model width (default {MODEL['dim']})")
    parser.add_argument("--depth", type=int, default=None,
                        help=f"transformer blocks (default {MODEL['depth']})")
    parser.add_argument("--heads", type=int, default=None,
                        help=f"attention heads (default {MODEL['heads']})")
    parser.add_argument("--kv_heads", type=int, default=None,
                        help="grouped-query attention: KV heads shared by "
                             "groups of q heads (default --heads)")
    parser.add_argument("--rope", action="store_true",
                        help="rotary position embeddings instead of the "
                             "learned table")
    parser.add_argument("--clip_norm", type=float, default=0.0,
                        help="global-norm gradient clipping (0 = off)")
    parser.add_argument("--weight_decay", type=float, default=None,
                        help="with --updater adamw (default 0.01 there): "
                             "decoupled weight decay on matrices only")
    parser.add_argument("--warmup_steps", type=int, default=0,
                        help="> 0: linear warm-up then cosine decay to 10%% "
                             "of --lr over --num_iters")
    parser.add_argument("--generate", type=int, default=0,
                        help="after training, decode this many tokens "
                             "through the KV cache; greedy unless "
                             "--temperature")
    parser.add_argument("--temperature", type=float, default=0.0,
                        help="sampling temperature for --generate "
                             "(0 = greedy)")
    parser.add_argument("--dropout", type=float, default=0.0,
                        help="GPT-style embedding + residual dropout "
                             "(train-time; per-step keys ride the batch); "
                             "incompatible with --accum")
    parser.add_argument("--dtype", default="float32",
                        choices=["float32", "bfloat16"],
                        help="worker-math precision (master weights and "
                             "the optimizer stay float32)")
    parser.add_argument("--comm", default="float32",
                        choices=["float32", "bfloat16", "int8"],
                        help="wire format of the step's pull and push")
    parser.add_argument("--max_len", type=int, default=None,
                        help="positional-embedding capacity (default "
                             f"{MODEL['max_len']}, grown to --seq_len)")


def _model_cfg(args, seq_len: int) -> dict:
    """MODEL with --dim/--depth/--heads overrides and positional capacity
    covering --max_len / --seq_len."""
    m = {**MODEL}
    for k in ("dim", "depth", "heads"):
        v = getattr(args, k, None)
        if v is not None:
            m[k] = v
    if m["heads"] < 1 or m["dim"] % m["heads"]:
        raise SystemExit(f"--dim {m['dim']} must divide by --heads "
                         f"{m['heads']} (>= 1)")
    kv = getattr(args, "kv_heads", None)
    if kv is not None:
        if kv < 1 or m["heads"] % kv:
            raise SystemExit(f"--kv_heads {kv} must divide --heads "
                             f"{m['heads']} (>= 1)")
        m["kv_heads"] = kv
    if getattr(args, "rope", False):
        if (m["dim"] // m["heads"]) % 2:
            raise SystemExit(f"--rope needs an even head dim "
                             f"(--dim {m['dim']} / --heads {m['heads']})")
        m["rope"] = True
    m["max_len"] = max(getattr(args, "max_len", None) or m["max_len"],
                       seq_len)
    return m


def _init_params(seed: int, model: dict, device) -> dict:
    """The initial LM, drawn from ``seed`` on ``device``. Tests replace it
    to start from the JAX package's weights."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return tfm.init(gen, device=device, **model)


def _init_moe_params(seed: int, model: dict, experts: int, device) -> dict:
    """The initial MoE LM of the ep layout (``init_moe_lm``'s expert
    hidden), drawn from ``seed`` on ``device``. Tests replace it."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return tfm.init_moe_lm(gen, vocab=model["vocab"], dim=model["dim"],
                           heads=model["heads"], depth=model["depth"],
                           max_len=model["max_len"], num_experts=experts,
                           kv_heads=model.get("kv_heads"),
                           rope=model.get("rope", False), device=device)


def _lr_schedule(cfg, args):
    """--warmup_steps > 0: linear warm-up, then cosine decay to 10% of the
    peak over the run; else the constant --lr."""
    warmup = getattr(args, "warmup_steps", 0)
    if not warmup:
        return cfg.table.lr
    total = max(cfg.train.num_iters, warmup + 1)
    return warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=cfg.table.lr, warmup_steps=warmup,
        decay_steps=total, end_value=0.1 * cfg.table.lr)


def _updater_kwargs(cfg, args, params) -> dict:
    kw = {}
    clip = getattr(args, "clip_norm", 0.0)
    if clip:
        kw["clip_norm"] = clip
    wd = getattr(args, "weight_decay", None)
    if cfg.table.updater == "adamw":
        kw["weight_decay"] = 0.01 if wd is None else wd
        kw["decay_mask"] = tfm.decay_mask(params)
    elif wd is not None:
        raise SystemExit("--weight_decay needs --updater adamw "
                         f"(got {cfg.table.updater})")
    return kw


def _refuse(cfg, args, layout: str) -> None:
    """The JAX app's refusals of flags that its layout does not wire."""
    if (getattr(args, "attn", "reference") in ("a2a", "a2a_flash")
            and layout != "sp"):
        raise SystemExit("--attn a2a/a2a_flash is sequence parallelism: "
                         f"use --layout sp (got {layout})")
    if layout not in ("dp", "sp"):
        for flag, default in (("attn", "reference"), ("accum", 1),
                              ("dtype", "float32"), ("comm", "float32"),
                              ("clip_norm", 0.0), ("warmup_steps", 0),
                              ("generate", 0)):
            if getattr(args, flag, default) != default:
                raise SystemExit(f"--{flag} is only wired into --layout "
                                 f"dp/sp (got {layout})")
        if cfg.table.updater == "adamw":
            raise SystemExit("--updater adamw is only wired into "
                             f"--layout dp/sp (got {layout})")
    for flag, default in (("remat", False), ("head_chunk", 0),
                          ("dropout", 0.0)):
        if layout != "dp" and getattr(args, flag, default):
            raise SystemExit(f"--{flag} is only wired into --layout dp "
                             f"(got {layout})")


def run(cfg: Config, args, metrics, group: Group = None) -> dict:
    """One rank of a training run. ``group`` is the default process group
    of the run's ranks, or None for one device; every rank calls ``run``
    with the same ``cfg`` and ``args``."""
    seq_len = getattr(args, "seq_len", 128)
    layout = getattr(args, "layout", "dp")
    _refuse(cfg, args, layout)
    device = resolve_device(getattr(args, "device", None))
    if layout in ("tp", "pp"):
        return _run_model_parallel(cfg, args, metrics, layout, seq_len,
                                   device, group)
    if layout == "ep":
        return _run_ep(cfg, args, metrics, seq_len, device, group)
    rank, n_shards = world(group)
    if layout == "sp" and seq_len % n_shards:
        raise SystemExit(f"--seq_len {seq_len} must divide by the "
                         f"{n_shards}-way group")
    if layout == "dp" and cfg.train.batch_size % n_shards:
        raise SystemExit(f"--batch_size {cfg.train.batch_size} must divide "
                         f"by the {n_shards}-way group")
    model = _model_cfg(args, seq_len)
    data = _load_data(cfg, args, seq_len)
    params = _init_params(cfg.train.seed, model, device)
    table = DenseTable(params, updater=cfg.table.updater,
                       lr=_lr_schedule(cfg, args), name=cfg.table.name,
                       updater_kwargs=_updater_kwargs(cfg, args, params),
                       device=device, group=group)
    del params  # the table holds the only copy
    heads = model["heads"]
    ckpt, start_step = _maybe_checkpointer(cfg, args, table, group)

    compute_dtype = (torch.bfloat16
                     if getattr(args, "dtype", "float32") == "bfloat16"
                     else None)
    dropout = getattr(args, "dropout", 0.0)
    if dropout and getattr(args, "accum", 1) > 1:
        # the accum fold splits every batch leaf into microbatches, which
        # a per-step key cannot survive
        raise SystemExit("--dropout is incompatible with --accum > 1")
    remat = getattr(args, "remat", False)
    if remat and getattr(args, "remat_mode", "full") != "full":
        remat = args.remat_mode
    step_kw = dict(accum=getattr(args, "accum", 1),
                   compute_dtype=compute_dtype,
                   comm=getattr(args, "comm", "float32"))
    if layout == "sp":
        # every rank holds the whole batch and its slice of the sequence;
        # the ring (or the all-to-all) stitches the slices together
        sp_grad, shard_batch = tfm.sp_train_wiring(
            heads, seq_len // n_shards, group,
            attn_impl=getattr(args, "attn", "reference"))
        step = table.make_step(sp_grad, **step_kw)

        def prep(batch):
            return shard_batch(torch.as_tensor(batch["tokens"],
                                               device=device))
    else:
        step = table.make_step(
            functools.partial(tfm.grad_fn, heads=heads,
                              attn_impl=getattr(args, "attn", "reference"),
                              remat=remat,
                              head_chunk=getattr(args, "head_chunk", 0),
                              dropout=dropout), **step_kw)
        drop_key = tfm.prng_key(cfg.train.seed + DROPOUT_SEED_OFFSET)
        n_prepped = [start_step]
        rows = cfg.train.batch_size // n_shards

        def prep(batch):
            out = {"tokens": torch.as_tensor(
                batch["tokens"][rank * rows:(rank + 1) * rows],
                device=device)}
            if dropout:
                # a fresh key per (resume-offset) step, then one per
                # worker; the keys stay on the host
                step_key = tfm.fold_in(drop_key, n_prepped[0])
                n_prepped[0] += 1
                out["rng"] = torch.tensor([tfm.fold_in(step_key, rank)],
                                          dtype=torch.int64)
            return out

    # TrainLoop fast-forwards the iterator to step_offset, so a resumed run
    # continues the stream instead of replaying it
    batches = BatchIterator(data, cfg.train.batch_size, seed=cfg.train.seed)
    ckpt_every = _ckpt_every(cfg, args)
    loop = TrainLoop(lambda b: table.step_inplace(step, prep(b)), batches,
                     metrics=metrics, log_every=cfg.train.log_every,
                     batch_size=cfg.train.batch_size, checkpointer=ckpt,
                     checkpoint_every=ckpt_every, step_offset=start_step)
    # a completed run resumed again is a no-op, not an extra step
    remaining = max(cfg.train.num_iters - start_step, 0)
    losses = loop.run(remaining)
    if ckpt is not None and remaining and not (
            ckpt_every and cfg.train.num_iters % ckpt_every == 0):
        ckpt.save(step=cfg.train.num_iters)  # not already saved by the loop
    if losses:
        metrics.log(final_loss=losses[-1], layout=layout, seq_len=seq_len,
                    tokens_per_sec=loop.timer.samples_per_sec * seq_len)
    out = {"losses": losses, "table": table, "layout": layout,
           "start_step": start_step,
           "samples_per_sec": loop.timer.samples_per_sec}
    gen = getattr(args, "generate", 0)
    if gen:
        from minips_tpu_torch.models import decode as dec

        prompt = torch.as_tensor(data["tokens"][:1, :min(8, seq_len)],
                                 device=device).long()
        temp = getattr(args, "temperature", 0.0)
        # decode at the training precision, so that greedy decoding stays
        # pinned to the training forward
        dd = compute_dtype if compute_dtype is not None else torch.float32
        sampler = (torch.Generator(device=device).manual_seed(
            cfg.train.seed) if temp else None)
        toks = dec.generate(table.pull(), prompt, gen, heads=heads,
                            temperature=temp, generator=sampler,
                            compute_dtype=dd, cache_dtype=dd)
        out["generated"] = toks[0].tolist()
        metrics.log(generated=out["generated"])
    return out


def _load_data(cfg, args, seq_len):
    path = getattr(args, "data_file", None)
    if path:
        from minips_tpu_torch.data.text import read_lm_file

        return read_lm_file(path, seq_len, max_windows=65536)
    return synthetic.lm_sequences(2048, seq_len, MODEL["vocab"],
                                  seed=cfg.train.seed)


def _ckpt_every(cfg, args) -> int:
    """Checkpoint cadence from the merged config, falling back to raw args
    (tests call run() with a bare Namespace)."""
    return (getattr(cfg.train, "checkpoint_every", 0)
            or getattr(args, "checkpoint_every", 0) or 0)


def _maybe_checkpointer(cfg, args, table, group: Group = None):
    """(Checkpointer or None, start step); the directory honours
    --config_file through cfg.train. Under a group rank 0 writes and every
    rank restores."""
    path = (getattr(cfg.train, "checkpoint_dir", None)
            or getattr(args, "checkpoint_dir", None))
    if not path:
        return None, 0
    from minips_tpu_torch.ckpt import make_checkpointer

    ckpt = make_checkpointer(path, {"lm": table}, group=group)
    start = 0
    if getattr(args, "resume", False) and ckpt.list_steps():
        start = ckpt.restore()
    return ckpt, start


def _sum_grads(grads, summed, group):
    """Each gradient whose ``summed`` flag is set, summed over ``group``
    (the ranks holding that leaf replicated with other batches)."""
    if world(group)[1] == 1:
        return grads
    return [all_reduce_sum(g, group) if s else g
            for g, s in zip(grads, summed)]


def _adam_train(cfg, args, metrics, params, loss_fn, summed, data_group,
                seq_len, layout, device, **log_fields) -> dict:
    """The shared tail of tp, pp and ep: the port's Adam at ``--lr`` on
    this rank's shards of ``params`` (one flat vector), the gradient of
    ``loss_fn(params, tokens)`` on this rank's rows of each batch, each
    leaf flagged in ``summed`` summed over ``data_group`` first;
    TrainLoop and the metrics."""
    d, n_data = world(data_group)
    flat, unravel = ravel(params, device)
    del params
    tx = make_updater("adam", cfg.table.lr)
    state = {"flat": flat, "opt": tx.init(flat)}
    rows = cfg.train.batch_size // n_data

    def do_step(batch):
        toks = torch.as_tensor(batch["tokens"][d * rows:(d + 1) * rows],
                               device=device).long()
        tree = unravel(state["flat"])
        leaves = [x.detach().requires_grad_(True) for x in tree_leaves(tree)]
        loss = loss_fn(tree_rebuild(tree, iter(leaves)), toks)
        grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
        g, _ = ravel(_sum_grads(grads, summed, data_group), device)
        updates, state["opt"] = tx.update(g, state["opt"], state["flat"])
        state["flat"] = state["flat"] + updates
        return loss.detach()

    data = _load_data(cfg, args, seq_len)
    batches = BatchIterator(data, cfg.train.batch_size, seed=cfg.train.seed)
    loop = TrainLoop(do_step, batches, metrics=metrics,
                     log_every=cfg.train.log_every,
                     batch_size=cfg.train.batch_size)
    losses = loop.run(cfg.train.num_iters)
    metrics.log(final_loss=losses[-1], layout=layout, seq_len=seq_len,
                tokens_per_sec=loop.timer.samples_per_sec * seq_len,
                **log_fields)
    return {"losses": losses, "params": unravel(state["flat"]),
            "layout": layout, "samples_per_sec": loop.timer.samples_per_sec}


def _run_model_parallel(cfg, args, metrics, layout, seq_len, device,
                        group) -> dict:
    """tp and pp: a (data x model) mesh of the ranks, weights and the
    optimizer state sharded over model."""
    from minips_tpu_torch.parallel.pipeline import stack_layers

    tp_size = getattr(args, "tp", 2)
    micro = getattr(args, "microbatches", 4)
    n_dev = world(group)[1]
    if n_dev % tp_size:
        raise SystemExit(f"--tp {tp_size} must divide {n_dev} devices")
    model = _model_cfg(args, seq_len)
    heads = model["heads"]
    if layout == "tp" and heads % tp_size:
        raise SystemExit(f"--tp {tp_size} must divide heads {heads}")
    if layout == "pp" and model["depth"] % tp_size:
        raise SystemExit(f"--tp {tp_size} must divide depth "
                         f"{model['depth']} (pipeline stages)")
    data_shards = n_dev // tp_size
    if cfg.train.batch_size % data_shards:
        raise SystemExit(f"--batch_size {cfg.train.batch_size} must divide "
                         f"by the {data_shards}-way data axis")
    local_b = cfg.train.batch_size // data_shards
    if layout == "pp" and local_b % micro:
        raise SystemExit(
            f"--microbatches {micro} must divide the per-device batch "
            f"{local_b} (= --batch_size {cfg.train.batch_size} / "
            f"{data_shards} data shards)")
    # the (data, model) groups of the run's ranks; one device has none
    data_group, model_group = ((None, None) if group is None
                               else make_groups(data_shards, tp_size))
    params = _init_params(cfg.train.seed, model, device)
    if layout == "pp":
        params = {**params, "blocks": stack_layers(params["blocks"])}
        specs = tfm.pp_specs(params)
    else:
        specs = tfm.tp_specs(params)
    params = shard_params(params, specs, axis_index(model_group), tp_size)

    def loss_fn(p, toks):
        if layout == "pp":
            logits = tfm.apply_pp(p, toks[:, :-1], heads=heads,
                                  group=model_group, num_microbatches=micro)
        else:
            logits = tfm.apply_tp(p, toks[:, :-1], heads=heads,
                                  group=model_group)
        return pmean(tfm.nll(logits, toks[:, 1:]), data_group)

    # over the data axis every leaf is replicated and every batch differs
    summed = [True] * len(tree_leaves(specs))
    return _adam_train(cfg, args, metrics, params, loss_fn, summed,
                       data_group, seq_len, layout, device, tp=tp_size)


def _run_ep(cfg, args, metrics, seq_len, device, group) -> dict:
    """ep: the MoE LM, the batch and the experts sharded over the ranks,
    the tokens sent to their experts by two all-to-alls a block."""
    rank, n_dev = world(group)
    model = _model_cfg(args, seq_len)
    heads = model["heads"]
    experts = getattr(args, "experts", 8)
    k_top = getattr(args, "k_top", 1)
    if not 1 <= k_top <= experts:
        raise SystemExit(f"--k_top {k_top} must be in [1, --experts "
                         f"{experts}] (0 would disable every MoE FFN)")
    if experts % n_dev:
        raise SystemExit(f"--experts {experts} must divide by the "
                         f"{n_dev}-way mesh")
    if cfg.train.batch_size % n_dev:
        raise SystemExit(f"--batch_size {cfg.train.batch_size} must "
                         f"divide by the {n_dev}-way mesh")
    local_tokens = (cfg.train.batch_size // n_dev) * seq_len
    capacity = getattr(args, "capacity", 0) or max(
        2 * k_top * local_tokens // experts, 4)
    params = _init_moe_params(cfg.train.seed, model, experts, device)
    specs = tfm.ep_lm_specs(params)
    params = shard_params(params, specs, rank, n_dev)

    def loss_fn(p, toks):
        logits, aux = tfm.apply_ep(p, toks[:, :-1], heads=heads, group=group,
                                   capacity=capacity, k_top=k_top)
        # the router's load-balance pressure beside the data-mean loss
        return pmean(tfm.nll(logits, toks[:, 1:]), group) + 0.01 * aux

    # the experts are sharded over the data axis; the rest is replicated
    summed = [dim is None for dim in tree_leaves(specs)]
    return _adam_train(cfg, args, metrics, params, loss_fn, summed, group,
                       seq_len, "ep", device, experts=experts, k_top=k_top,
                       capacity=capacity)


def _run_cli(cfg, args, metrics) -> dict:
    """``--ranks`` spawned ranks; without it, dp runs here and sp, tp, pp
    and ep on one rank per visible card (one gloo rank on the CPU)."""
    n = getattr(args, "ranks", 0)
    if not n and getattr(args, "layout", "dp") != "dp":
        cpu = resolve_device(getattr(args, "device", None)).type == "cpu"
        n = 1 if cpu else torch.cuda.device_count()
    return run_cli(run, cfg, args, metrics, ranks=n)


def main():
    return app_main("lm_example", DEFAULT, _run_cli, extra_flags=_flags)


if __name__ == "__main__":
    main()
