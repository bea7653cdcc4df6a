"""Program glue of the ``lm`` family: the decoder LM that
``minips_tpu_torch.apps.lm.build_lm`` builds (one ``DenseTable`` holding
the whole model, Adam, its fused step with flash attention, the chunked
tied head and remat), stepped by ``DenseTable.step_inplace``.

``checked_steps`` drives the first three steps and reads the table's own
state: each leaf's first gradient from Adam's first moment after one step
(``reference/common.py``), and each leaf's change after three from the
flat parameter vector (a copy of the start is kept until then).
"""

from __future__ import annotations

import os

import torch

from benchmark import compare, roofline, spec, traffic
from minips_tpu_torch.apps.lm import build_lm

common = spec.load_module(os.path.join(spec.HERE, "reference", "common.py"),
                          "benchmark_reference_common")
CHECKED_STEPS = 3
# K2 runs twice a block a step (the forward and its recompute under any
# remat), K3 and K4 once
FLASH_LAUNCHES = {"flash_fwd": 2, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}


class Program:
    def __init__(self, config: dict, mix: dict, seed: int,
                 device: torch.device):
        if mix["seq"] != config["n_positions"]:
            raise ValueError(f"the mix's sequences of {mix['seq']} must fill "
                             f"the {config['n_positions']} positions")
        self.config, self.mix = config, mix
        self.lm = build_lm(
            mix["batch"], mix["seq"], dim=config["n_embd"],
            depth=config["n_layer"], vocab=config["vocab_size"],
            device=device, seed=seed, head_chunk=config["head_chunk"],
            remat=config["remat"],
            compute_dtype=getattr(torch, config["compute_dtype"]),
            opt_state="f32")
        if self.lm.heads != config["n_head"]:
            raise ValueError(f"the program builds {self.lm.heads} heads, "
                             f"the configuration states {config['n_head']}")
        self.lm.batches = None  # the builder's own two batches: not used
        self.pool = traffic.make(mix, config, seed, device)
        self.units = {"tokens": mix["batch"] * mix["seq"]}
        self.i = 0

    def step(self):
        """One step of the window on the next batch of the pool; returns
        the loss (a device scalar)."""
        b = self.pool[self.i % len(self.pool)]
        self.i += 1
        return self.lm.table.step_inplace(self.lm.step, b)

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
        """Model flops a token (``roofline.py``) and each flash launch's
        least time at this cell's shapes (bf16)."""
        cfg, mix = self.config, self.mix
        d, h = cfg["n_embd"], cfg["n_head"]
        per = roofline.flash_work(mix["batch"], mix["seq"], h, d // h)
        return {"flops_per_token": roofline.lm_flops_per_token(
                    cfg["n_layer"], d, cfg["vocab_size"], mix["seq"]),
                "flash_flops_bytes": per,
                "flash_launches_per_step": {
                    k: n * cfg["n_layer"] for k, n in FLASH_LAUNCHES.items()}}

    def free(self) -> None:
        self.pool = self.pool[:CHECKED_STEPS]
        self.lm = None
