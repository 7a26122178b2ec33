"""Typed experiment configuration: one dataclass and named presets mirroring
the reference experiments one-to-one."""

from qtos_torch.config.experiments import EXPERIMENTS, ExperimentConfig, get_experiment  # noqa: F401
