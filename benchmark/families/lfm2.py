"""Program glue of the ``lfm2`` family: LFM2 as
``minips_tpu_torch.apps.lm.build_lm`` builds it from its configuration
(one ``DenseTable`` holding the whole held model, Adam, its fused step
with flash attention, the chunked tied head, remat, and the dropless MoE
over this card's experts), stepped by ``DenseTable.step_inplace``.

``checked_steps`` drives the first three steps and reads the table's own
state, as the ``lm`` family's does: each leaf's first gradient from
Adam's first moment after one step (``reference/common.py``), and each
leaf's change after three from the flat parameter vector.

On the card the steps after those three are the same fused step captured
as one CUDA graph (``DenseTable.capture_step``, at the first of them, the
set-up's warm-up) and replayed: the step launches some 10^4 kernels,
whose dispatch through the selective remat's Python dispatch mode takes
about half of the card's time and, on a busy host, paced it. A step run
under a profiler (the traced steps) releases the graph and runs eagerly,
so that its spans and counters are recorded.
"""

from __future__ import annotations

import os

import torch

from benchmark import compare, lfm2_work, spec, traffic
from minips_tpu_torch.apps.lm import build_lm
from minips_tpu_torch.utils.profiling import tracing

common = spec.load_module(os.path.join(spec.HERE, "reference", "common.py"),
                          "benchmark_reference_common")
CHECKED_STEPS = 3


class Program:
    def __init__(self, config: dict, mix: dict, seed: int,
                 device: torch.device):
        if mix["seq"] > config["max_position_embeddings"]:
            raise ValueError(f"the mix's sequences of {mix['seq']} exceed "
                             f"the {config['max_position_embeddings']} "
                             "positions")
        self.config, self.mix = config, mix
        self.lm = build_lm(
            mix["batch"], mix["seq"], device=device, seed=seed,
            head_chunk=config["head_chunk"], remat=config["remat"],
            compute_dtype=getattr(torch, config["compute_dtype"]),
            opt_state="f32", config=config, lr=config["optimizer"]["lr"])
        self.lm.batches = None  # build_lm's own two batches: not used
        self.pool = traffic.make(mix, config, seed, device)
        self.units = {"tokens": mix["batch"] * mix["seq"]}
        self.i = 0
        # the captured step: None before it, False once released
        self.graphed = None if device.type == "cuda" else False

    def step(self):
        """One step on the next batch of the pool; returns the loss (a
        device scalar). Past the checked steps, on the card, a replay of
        the captured step, or an eager step under a profiler."""
        b = self.pool[self.i % len(self.pool)]
        self.i += 1
        table = self.lm.table
        if self.graphed and tracing():
            self.graphed.release()
            self.graphed = False
        if self.graphed:
            return self.graphed(b)
        if self.graphed is None and self.i > CHECKED_STEPS and not tracing():
            self.graphed, loss = table.capture_step(self.lm.step, b)
            return loss
        return table.step_inplace(self.lm.step, b)

    def checked_steps(self) -> dict:
        t, b1 = self.lm.table, self.config["optimizer"]["b1"]
        p0 = t.params.clone()
        losses = [[float(self.step())]]
        # Adam's state is [count, mu, nu]
        grad = {k: compare.norm(common.grad_from_adam_m(mu, b1))
                for k, mu in compare.flat(t.unravel(t.opt_state[1])).items()}
        for _ in range(CHECKED_STEPS - 1):
            losses.append([float(self.step())])
        p0.neg_().add_(t.params)  # the change, in place of the start
        delta = {k: compare.norm(v)
                 for k, v in compare.flat(t.unravel(p0)).items()}
        del p0
        return {"loss": losses, "grad": grad, "delta": delta}

    def check_inputs(self) -> list[dict]:
        return self.pool[:CHECKED_STEPS]

    def work(self) -> dict:
        """Model flops a token (``lfm2_work.py``) and the expert GEMMs'
        widths, for the readers of ``benchmark/metrics/*.lfm2.py``."""
        cfg = self.config
        return {"flops_per_token": lfm2_work.flops_per_token(
                    cfg, self.mix["seq"]),
                "experts": {"d": cfg["hidden_size"],
                            "f": cfg["moe_intermediate_size"],
                            "held": cfg["num_experts"]}}

    def free(self) -> None:
        if self.graphed:
            self.graphed.release()
        self.graphed = False
        self.pool = self.pool[:CHECKED_STEPS]
        self.lm = None
