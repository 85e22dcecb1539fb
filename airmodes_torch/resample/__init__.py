"""Rational-rate resampling of SDR captures to the channel rate: the
polyphase group-matmul resampler (`polyphase`) and the fused resample ->
int8 quantize -> planar demod step (`fused`)."""
