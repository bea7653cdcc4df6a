"""The traffic generators: one general generator a mix ``kind``, driven by
the mix's data file (``benchmark/traffic/<mix>.json``) and the
configuration's own data sizes. Every batch is made on the device from
``torch.Generator(device).manual_seed(seed)``, in a few large calls: the
same seed gives the same pool of batches, and every seed the same sizes.
"""

from __future__ import annotations

import torch


def zipf_ranks(u: torch.Tensor, n: torch.Tensor, s: float) -> torch.Tensor:
    """Ranks in ``[0, n)`` of a Zipf(``s``) popularity, ``s != 1``, by the
    inverse transform of its continuous envelope ``x^-s`` on ``[1, n+1)``:
    ``x = (1 + u((n+1)^(1-s) - 1))^(1/(1-s))``, rank ``floor(x) - 1``.
    ``u`` uniform in [0, 1), float64 (40M ranks need more than float32's
    24 bits); ``n`` broadcasts against it (one count a field)."""
    a = 1.0 - s
    x = torch.pow(1.0 + u * (torch.pow(n + 1.0, a) - 1.0), 1.0 / a)
    return torch.minimum(x.floor().to(torch.int64) - 1,
                         n.to(torch.int64) - 1).clamp(min=0)


def ctr_zipf(mix: dict, config: dict, seed: int, device) -> list[dict]:
    """A pool of ``mix["pool"]`` CTR batches of ``mix["batch"]`` rows:
    ``dense`` [B, num_dense] standard normal, ``cat`` [B, num_cat] int64
    ids (field f's Zipf rank plus the ids of the fields before it, so the
    fields' id spaces are disjoint, as Criteo's per-column vocabularies
    are) and ``y`` [B] clicks of a planted linear model (the repo's
    ``criteo_like`` recipe: the dense features, the ids mod a prime, and
    noise)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    counts = torch.tensor(config["field_ids"], dtype=torch.float64,
                          device=device)
    offsets = torch.cumsum(counts, 0).to(torch.int64) - counts.to(torch.int64)
    b, nd = mix["batch"], config["num_dense"]
    lab = mix["label"]
    w_dense = torch.randn(nd, generator=gen, device=device)
    pool = []
    for _ in range(mix["pool"]):
        u = torch.rand((b, counts.numel()), generator=gen, device=device,
                       dtype=torch.float64)
        cat = zipf_ranks(u, counts, mix["zipf_exponent"]) + offsets
        dense = torch.randn((b, nd), generator=gen, device=device)
        effect = ((cat % lab["id_mod"]).to(torch.float32) / lab["id_mod"]
                  - 0.5).sum(-1)
        logit = (lab["dense_weight"] * (dense @ w_dense)
                 + lab["id_weight"] * effect
                 + lab["noise"] * torch.randn(b, generator=gen,
                                              device=device))
        pool.append({"dense": dense, "cat": cat,
                     "y": (logit > 0).to(torch.float32)})
    return pool


def lm_uniform(mix: dict, config: dict, seed: int, device) -> list[dict]:
    """A pool of ``mix["pool"]`` batches ``{"tokens": [B, seq + 1]}`` of
    ids uniform over the configuration's vocabulary."""
    gen = torch.Generator(device=device).manual_seed(seed)
    shape = (mix["batch"], mix["seq"] + 1)
    return [{"tokens": torch.randint(0, config["vocab_size"], shape,
                                     generator=gen, device=device)}
            for _ in range(mix["pool"])]


KINDS = {"ctr_zipf": ctr_zipf, "lm_uniform": lm_uniform}


def make(mix: dict, config: dict, seed: int, device) -> list[dict]:
    """The pool of batches of a mix, by its ``kind``."""
    if mix["kind"] not in KINDS:
        raise ValueError(f"unknown traffic kind {mix['kind']!r}; known: "
                         f"{sorted(KINDS)}")
    return KINDS[mix["kind"]](mix, config, seed, device)
