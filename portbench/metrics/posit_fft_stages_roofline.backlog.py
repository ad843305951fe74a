"""The FFT stage-range kernel's share of its roofline: its calls' bytes
read and written once over 3.35 TB/s (or their operations over the f32
peak), over its device time in the traced window, in %."""
from portbench.lib.readers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "posit_fft_stages")
