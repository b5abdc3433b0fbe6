"""Score networks: GroupNorm32 and the SD-1.x stack."""
