"""Where the port runs: the card unless the caller asks for the CPU."""

from typing import Union

import torch

from dlrover_tpu_torch.common import env_utils

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means this worker's card, ``cuda:LOCAL_RANK``; it raises
    when there is no card. Anything else is taken as given, so the CPU
    is used only when the caller names it."""
    if device is not None:
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} asked for, but CUDA is absent")
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda", env_utils.LOCAL_RANK.get())

