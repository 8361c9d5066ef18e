"""Published peak of one NVIDIA H100 SXM (data sheet, dense, at its 700 W
limit), the yardstick of the whole step's share of the chip's peak."""

BF16_FLOP_PER_S = 989e12
