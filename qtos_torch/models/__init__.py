"""Robot models."""

from qtos_torch.models.solo12 import Solo12  # noqa: F401
