"""A tensor on a device the port has no route for: the shape and dtype of
a given tensor on ``xla``, with no storage and no operator."""

import torch


class _Elsewhere(torch.Tensor):
    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        raise RuntimeError(f"{func} has no implementation on this device")


def elsewhere(t: torch.Tensor) -> torch.Tensor:
    """``t``'s shape and dtype on the ``xla`` device."""
    return torch.Tensor._make_wrapper_subclass(_Elsewhere, t.shape, dtype=t.dtype, device=torch.device("xla"))
