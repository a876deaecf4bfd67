"""The whole step's share of the chip's peak: the model's matrix products a
unit (the reference's count) over the time a unit takes in the untraced
part of the window, against the bf16 peak for an AMP configuration (float32
otherwise), in percent."""


def read(r, name):
    return 100.0 * r.flops / (r.unit_s * r.peak_flops)
