"""The enhancer's ``dft_precision`` against the JAX package's, on the
committed fixtures, on the CPU.

``highest``, ``high`` and ``default`` each enhance as the JAX enhancer with
the same setting does, within ``test_torch_enhancer.py``'s tolerances
(float32 I/O 5e-5 absolute, int16 within 1 PCM16 LSB): on the CPU both
reconstruct in float32 whatever is set (the JAX package's CPU matmuls
ignore the precision; the port's reconstruction is float32 everywhere,
kernel K3 on the card). Any other value raises the JAX ``ValueError``, in
the enhancer and in the serve and enhance CLIs' parsers.
"""

import pytest
import torch

from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.cli import (
    enhance as enhance_cli,
    serve as serve_cli,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.inference import (
    AudioEnhancer,
)
from test_torch_enhancer import ATOL, LSB, _assert_close, _clips, _enhancers, pair  # noqa: F401

torch.set_num_threads(2)


@pytest.mark.parametrize("precision", ["highest", "high", "default"])
@pytest.mark.parametrize("io_dtype", ["float32", "int16"])
def test_dft_precision_matches_jax(pair, precision, io_dtype):  # noqa: F811
    je, te = _enhancers(pair, io_dtype=io_dtype, dft_precision=precision)
    assert te.dft_precision == precision
    wavs = _clips(1)
    _assert_close(te.enhance_batch(wavs), je.enhance_batch(wavs),
                  ATOL if io_dtype == "float32" else LSB + 1e-6)


def test_invalid_dft_precision_raises(pair):  # noqa: F811
    _, _, tm, cfg = pair
    with pytest.raises(ValueError, match="dft_precision must be highest|high|default"):
        AudioEnhancer(tm, cfg, device="cpu", dft_precision="fastest")
    for cli in (enhance_cli, serve_cli):
        args = cli.build_parser().parse_args(
            ["--checkpoint", "c", "--dft-precision", "high"]
            + (["--input", "i", "--output", "o"] if cli is enhance_cli else []))
        assert args.dft_precision == "high"
        with pytest.raises(SystemExit):
            cli.build_parser().parse_args(["--checkpoint", "c", "--dft-precision", "fastest"])
