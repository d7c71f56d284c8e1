"""Compatibility façades for users arriving from the reference's ecosystems."""

from uccl_tpu_torch.compat import dist

__all__ = ["dist"]
