"""One launched rank of the port's ``multihost_example``, its model
started from the JAX package's initial state, so that the job can be held
against the JAX example's job with the same flags.

The JAX example draws its tables and weights from ``jax.random``, which
torch cannot replay. The test builds them with the JAX package, pickles
them (``{"wd": {"wide": state, "emb": state, "deep": (params, opt)}}`` or
``{"lm": params tree}``, numpy leaves) and launches this script on every
rank:

    python tests/torch_cssp_rank.py INIT.pkl --model wd --mode bsp ...

It makes ``wide_deep_example.build`` load those states (W&D) or
``transformer.init`` return those weights (LM), sets the deep tower's
and the LM's loss compute in float32 when ``MINIPS_TEST_F32`` is set,
and runs the example's ``main`` on the remaining flags. It imports neither
JAX nor the JAX package.
"""

from __future__ import annotations

import functools
import os
import pickle
import sys

import torch

from minips_tpu_torch import interop
from minips_tpu_torch.apps import multihost_example, wide_deep_example
from minips_tpu_torch.models import mlp, transformer


def main() -> int:
    with open(sys.argv[1], "rb") as f:
        init = pickle.load(f)
    if os.environ.get("MINIPS_TEST_F32"):
        mlp.apply = functools.partial(mlp.apply,
                                      compute_dtype=torch.float32)
        transformer.loss = functools.partial(transformer.loss,
                                             compute_dtype=torch.float32)
    if "wd" in init:
        orig = wide_deep_example.build

        def build(cfg, **kw):
            ps, (wide, emb, deep) = orig(cfg, **kw)
            interop.load_sparse(wide, init["wd"]["wide"])
            interop.load_sparse(emb, init["wd"]["emb"])
            interop.load_dense(deep, *init["wd"]["deep"], refit=True)
            return ps, (wide, emb, deep)

        wide_deep_example.build = build
    if "lm" in init:
        def lm_init(gen, *, device=None, **kw):
            return interop.tree_from_numpy(init["lm"], device)

        transformer.init = lm_init
    return multihost_example.main(sys.argv[2:])


if __name__ == "__main__":
    sys.exit(main())
