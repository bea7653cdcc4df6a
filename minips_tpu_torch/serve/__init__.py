"""Read-mostly serving for the sharded PS — the part of
``minips_tpu/serve/`` ported so far: :mod:`minips_tpu_torch.serve.hedge`,
the hedged-pull config (``MINIPS_HEDGE``) the trainer's constructor reads.

The serving plane and its admission (``plane``, ``admission``) wait for
ROADMAP.md queue 1 item 14.2b; ``MINIPS_SERVE`` raises
``NotImplementedError``.
"""
