"""Seeds of per-step ``torch.Generator`` draws."""

from __future__ import annotations

_MASK = 0xFFFFFFFFFFFFFFFF


def mix_seed(seed: int, step: int) -> int:
    """A 64-bit seed that is a pure function of ``(seed, step)``, as
    ``jax.random.fold_in(PRNGKey(seed), step)`` is a key of both: splitmix64
    of the two packed into one word.  Every bit depends on both, which
    matters on the CPU, whose generator keeps only the low 32 bits of a
    seed (CUDA's keeps all 64)."""
    z = (((int(seed) & 0xFFFFFFFF) << 32) | (int(step) & 0xFFFFFFFF)) & _MASK
    z = (z + 0x9E3779B97F4A7C15) & _MASK
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK
    return z ^ (z >> 31)
