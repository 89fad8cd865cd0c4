"""Monte-Carlo statistics containers and confidence intervals.

The reference only prints running FER/BER (`ldpc_128_testing.py:120-137`);
here stats are first-class, with binomial confidence intervals because RNG
parity with the reference is impossible and FER parity must be statistical
(SURVEY.md §6/§7 hard-part 5).

A copy of ``short_ldpc_decoding_osd_tpu/utils/metrics.py``.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass
class DecodeStats:
    """Accumulated frame statistics for one operating point."""

    frames: int = 0
    frame_errors: int = 0
    bit_errors: int = 0
    bits_per_frame: int = 0
    detected_failures: int = 0
    undetected_errors: int = 0

    def merge(self, other: "DecodeStats") -> "DecodeStats":
        return DecodeStats(
            frames=self.frames + other.frames,
            frame_errors=self.frame_errors + other.frame_errors,
            bit_errors=self.bit_errors + other.bit_errors,
            bits_per_frame=max(self.bits_per_frame, other.bits_per_frame),
            detected_failures=self.detected_failures + other.detected_failures,
            undetected_errors=self.undetected_errors + other.undetected_errors,
        )

    @property
    def fer(self) -> float:
        return self.frame_errors / max(self.frames, 1)

    @property
    def ber(self) -> float:
        return self.bit_errors / max(self.frames * max(self.bits_per_frame, 1), 1)

    @property
    def ufer(self) -> float:
        return self.undetected_errors / max(self.frames, 1)

    def fer_confidence(self, z: float = 1.96) -> tuple[float, float]:
        """Wilson score interval for the FER."""
        return wilson_interval(self.frame_errors, self.frames, z)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self) | {
            "fer": self.fer,
            "ber": self.ber,
            "ufer": self.ufer,
        }


def wilson_interval(successes: int, trials: int, z: float = 1.96) -> tuple[float, float]:
    if trials == 0:
        return 0.0, 1.0
    p = successes / trials
    denom = 1.0 + z * z / trials
    center = (p + z * z / (2 * trials)) / denom
    half = (z / denom) * math.sqrt(p * (1 - p) / trials + z * z / (4 * trials * trials))
    return max(0.0, center - half), min(1.0, center + half)
