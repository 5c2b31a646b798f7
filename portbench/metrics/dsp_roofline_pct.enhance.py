"""K1 and K3 (the port's kernels that ``sevit::stft_mag`` and
``sevit::istft_polar`` launch: ``stft_mag`` or ``stft_dft``, ``istft_polar``
or ``istft_dft``) in the traced slice against ``work.stft_work``'s bound: an
FFT's operations at the fp32 rate or its bytes over HBM's, whichever is
larger."""

from portbench.readers import roofline_pct


def read(ctx):
    works = [w for d in ctx.facts.get("traced_dsp", []) for w in (d["stft"], d["istft"])]
    return roofline_pct(ctx, ("stft_mag", "stft_dft", "istft_polar", "istft_dft"), works, "fp32")
