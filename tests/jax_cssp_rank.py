"""One launched rank of the JAX package's ``multihost_example`` with its
deep tower and its LM loss computing in float32 when ``MINIPS_TEST_F32``
is set (the counterpart of ``tests/torch_cssp_rank.py``'s switch), so
that a job of each package can be held to the other's at float32:

    python tests/jax_cssp_rank.py --model wd --mode bsp ...
"""

from __future__ import annotations

import functools
import os
import sys


def main() -> int:
    if os.environ.get("MINIPS_TEST_F32"):
        import jax.numpy as jnp

        from minips_tpu.models import mlp, transformer

        mlp.apply = functools.partial(mlp.apply, compute_dtype=jnp.float32)
        transformer.loss = functools.partial(transformer.loss,
                                             compute_dtype=jnp.float32)
    from minips_tpu.apps import multihost_example

    return multihost_example.main(sys.argv[1:])


if __name__ == "__main__":
    sys.exit(main())
