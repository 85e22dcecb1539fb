"""Frozen copies of the program's modules that the benchmark's yardstick
needs (the generator's encoder and field encoders, the CRC it appends, the
configuration, the FIR design, the operation counts and the planar layout's
geometry): later changes to the program do not move the yardstick."""
