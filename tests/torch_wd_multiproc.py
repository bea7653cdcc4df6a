"""One launched rank of the port's Wide&Deep ``--exec multiproc``, its
deep tower started from given weights, so that the job can be held
against the JAX app's job with the same flags.

The JAX app draws the deep tower's initial weights from ``PRNGKey(seed +
2)``, which a ``torch.Generator`` cannot replay. The test draws them with
the JAX package, saves them to an ``.npz`` (keys ``w0``, ``b0``, ...) and
launches this script on every rank:

    python tests/torch_wd_multiproc.py DEEP0.npz --exec multiproc ...

It replaces ``models.wide_deep.init_deep`` with a function that returns
those weights and runs the app's ``main`` on the remaining flags. It
imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from minips_tpu_torch.apps import wide_deep_example
from minips_tpu_torch.models import wide_deep as wd_model


def main() -> None:
    with np.load(sys.argv[1]) as f:
        deep0 = {k: f[k] for k in f.files}

    def init_deep(generator, *args, device=None, **kwargs):
        return {k: torch.from_numpy(v.copy()).to(device)
                for k, v in deep0.items()}

    wd_model.init_deep = init_deep
    sys.argv = [sys.argv[0]] + sys.argv[2:]
    wide_deep_example.main()


if __name__ == "__main__":
    main()
