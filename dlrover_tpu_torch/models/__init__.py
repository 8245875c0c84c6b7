"""Model zoo of the port (counterpart of ``dlrover_tpu/models``)."""

from dlrover_tpu_torch.models.gpt import GPT, GPTConfig, loss_fn  # noqa: F401
