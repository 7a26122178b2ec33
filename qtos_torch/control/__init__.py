"""Control: the 1 kHz tracking loop over trajectory tables."""

from qtos_torch.control.loop import ControlParams, decode_row, playback, stance_warmup, TrackingMetrics  # noqa: F401
