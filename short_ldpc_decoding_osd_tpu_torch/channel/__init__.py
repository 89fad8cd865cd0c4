from .awgn import ChannelSpec, blend_moments, sample_batch, sigma_for_snr

__all__ = ["ChannelSpec", "blend_moments", "sample_batch", "sigma_for_snr"]
