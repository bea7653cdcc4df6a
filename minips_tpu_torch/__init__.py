"""minips_tpu_torch — the PyTorch and CUDA port of ``minips_tpu``.

The JAX package stays the reference; this package runs beside it on an
NVIDIA H100 and imports neither JAX nor anything of ``minips_tpu``.
Module paths mirror the JAX package's, so each counterpart is easy to
find. Every entry point takes ``device=`` and defaults to the card; the
CPU runs only when a caller asks for it (the parity tests do).

Ported so far: the fused LR + MLP parameter-server training step
(``apps/lrmlp.py``), whose every row gather runs through the hand-written
CUDA kernel of ``ops/gather.py``; the decoder LM's dense training step
(``apps/lm.py``), whose attention runs through the hand-written flash
kernels of ``ops/flash_attention.py``, with its optimizer state in float32,
bfloat16 or blockwise int8; and the threaded ``Engine`` path
(``core/engine.py``: worker threads pulling and pushing through the
BSP/SSP/ASP controllers of ``consistency/``), which drives the
Wide&Deep/DeepFM app (``apps/wide_deep_example.py``) beside its fused mode;
and the multi-process parameter server (``train/sharded_ps.py`` under
``launch.py``: ``--exec multiproc``), whose numpy servers are the JAX
package's and whose ranks step on their own devices. Importing the package
touches no device: a launcher forks CPU ranks from a server that imported
it.
"""

import torch

# Full float32 products and convolutions: TF32 keeps about three decimal
# digits and would loosen every comparison with the JAX package.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
