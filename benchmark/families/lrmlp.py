"""Program glue of the ``lrmlp`` family: the LR + MLP pair that
``minips_tpu_torch.apps.lrmlp.build_lrmlp`` builds, stepped through its two
``PSTrainStep`` calls on one batch (one step of the window).

``checked_steps`` drives the first three steps and reads the program's own
state around them: the rows of the slots the steps touch (found by the
configuration's hash, ``reference/common.py``) and the dense tables'
vectors, before, after the first step and after the third. The first
gradient of each leaf is worked out from its state after one step
(``reference/common.py``'s rules: the rows' and LR's Adagrad from the
change and the accumulator, the tower's Adam from its first moment).
"""

from __future__ import annotations

import os

import torch

from benchmark import compare, roofline, spec, traffic
from minips_tpu_torch.apps.lrmlp import build_lrmlp

common = spec.load_module(os.path.join(spec.HERE, "reference", "common.py"),
                          "benchmark_reference_common")
CHECKED_STEPS = 3


class Program:
    """The pair at the mix's batch, the configuration's table size and
    tower precision, and the mix's pool of batches on the device."""

    def __init__(self, config: dict, mix: dict, seed: int,
                 device: torch.device):
        self.config, self.mix = config, mix
        self.ns = build_lrmlp(
            mix["batch"], device, seed=seed, num_slots=config["num_slots"],
            mlp_compute_dtype=getattr(torch, config["tower_compute_dtype"]))
        self.ns.batches = None  # the builder's own two batches: not used
        self.pool = traffic.make(mix, config, seed, device)
        self.units = {"samples": mix["batch"]}
        self.i = 0

    def step(self):
        """One step of the window: the LR step and the MLP step on the
        next batch of the pool. Returns both losses (device scalars)."""
        b = self.pool[self.i % len(self.pool)]
        self.i += 1
        return self.ns.lr_step(b), self.ns.mlp_step(b)

    def _tables(self):
        return {"wide": self.ns.wide, "emb": self.ns.emb}

    def _dense(self):
        return {"lin": self.ns.lin, "deep": self.ns.deep}

    def checked_steps(self) -> dict:
        cfg = self.config
        uniq = {name: torch.unique(torch.cat([
            common.slot_hash(b["cat"], cfg["num_slots"], salt).reshape(-1)
            for b in self.pool[:CHECKED_STEPS]]))
            for name, salt in cfg["salts"].items()}

        def snap():
            out = {k: t.emb[uniq[k]] for k, t in self._tables().items()}
            for name, t in self._dense().items():
                out.update({f"{name}.{k}": v.clone() for k, v in
                            compare.flat(t.unravel(t.params)).items()})
            return out

        p0 = snap()
        losses = [[float(x) for x in self.step()]]
        p1 = snap()
        tu, lu, du = (cfg["table_updater"], cfg["lin_updater"],
                      cfg["tower_updater"])
        grad = {k: compare.norm(common.grad_from_row_adagrad(
                    p1[k] - p0[k], t.accum[uniq[k]], tu["lr"], tu["eps"]))
                for k, t in self._tables().items()}
        lin, deep = self.ns.lin, self.ns.deep
        # lin's Adagrad state is [sum of squares]; deep's Adam [count, mu, nu]
        for k, acc in compare.flat(lin.unravel(lin.opt_state[0])).items():
            grad[f"lin.{k}"] = compare.norm(common.grad_from_adagrad(
                p1[f"lin.{k}"] - p0[f"lin.{k}"], acc, lu["lr"], lu["eps"]))
        for k, mu in compare.flat(deep.unravel(deep.opt_state[1])).items():
            grad[f"deep.{k}"] = compare.norm(
                common.grad_from_adam_m(mu, du["b1"]))
        for _ in range(CHECKED_STEPS - 1):
            losses.append([float(x) for x in self.step()])
        p3 = snap()
        return {"loss": losses, "grad": grad,
                "delta": {k: compare.norm(p3[k] - p0[k]) for k in p0}}

    def check_inputs(self) -> list[dict]:
        """The batches of the checked steps, in order."""
        return self.pool[:CHECKED_STEPS]

    def work(self) -> dict:
        """What a step needs: its flops and bytes (``roofline.py``), and
        the row gather's bytes, from the distinct slots of the pool's own
        keys (a mean over the pool's batches), with their share of the
        step's keys."""
        cfg, b = self.config, self.mix["batch"]
        keys = b * cfg["num_cat"]
        sizes = ([cfg["num_dense"] + cfg["num_cat"] * cfg["emb_dim"]]
                 + list(cfg["hidden"]) + [1])
        dims = {"wide": cfg["wide_dim"], "emb": cfg["emb_dim"]}
        unique = {name: sum(torch.unique(common.slot_hash(
            x["cat"], cfg["num_slots"], salt)).numel() for x in self.pool)
            / len(self.pool) for name, salt in cfg["salts"].items()}
        item = self.pool[0]
        inputs = sum(x.element_size() * x[0].numel() for x in item.values())
        dense = (4 * 2 * 2 * self.ns.lin.num_keys        # w, acc: r + w
                 + 4 * 3 * 2 * self.ns.deep.num_keys)    # w, m, v: r + w
        nbytes = (b * inputs + dense
                  + sum(roofline.sparse_step_bytes(keys, unique[k], d)
                        for k, d in dims.items()))
        flops = roofline.mlp_flops(b, sizes) + 6.0 * b * cfg["num_dense"]
        return {"step_flops": flops, "step_bytes": nbytes,
                "k1_bytes": sum(roofline.gather_bytes(keys, unique[k], d)
                                for k, d in dims.items()),
                "unique_rows_ratio": {k: u / keys for k, u in unique.items()}}

    def free(self) -> None:
        self.pool = self.pool[:CHECKED_STEPS]
        self.ns = None
