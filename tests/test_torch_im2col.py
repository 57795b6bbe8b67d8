"""The library yardsticks that ``chip_smoke.py`` times beside K1 and K7
compute the kernels' functions.

K1's is one PyTorch call, ``chip_smoke.im2col_unfold`` (``unfold`` twice,
a permute, one strided copy); it must give ``im2col_patches_plain``'s
tensor bit for bit, so its time measures the same function.  K7's is
``F.fold`` on ``chip_smoke.fold_input``'s layout, which sums the same taps
in another order.  The kernels themselves are held to the same twins on
the card in ``tests/test_torch_gpu.py``.  CPU only, seconds.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels import conv_im2col as k12

_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(chip_smoke)

# (b, h, w, c, k, stride): MNIST PrimaryCaps and Conv1, SVHN Conv1, and a
# ragged stride-2 case with H != W and C = 5.
SHAPES = [(2, 20, 20, 256, 9, 2), (2, 28, 28, 1, 9, 1),
          (2, 32, 32, 3, 9, 1), (2, 21, 19, 5, 3, 2)]


def _x(b, h, w, c, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((b, h, w, c), np.float32))


@pytest.mark.parametrize("b,h,w,c,k,stride", SHAPES)
def test_unfold_yardstick_is_the_plain_twin_bit_for_bit(b, h, w, c, k,
                                                         stride):
    x = _x(b, h, w, c)
    assert torch.equal(chip_smoke.im2col_unfold(x, k, k, stride),
                       k12.im2col_patches_plain(x, kh=k, kw=k,
                                                stride=stride))


@pytest.mark.parametrize("b,h,w,c,k,stride", SHAPES)
def test_fold_yardstick_computes_col2im(b, h, w, c, k, stride):
    oh, ow = k12.out_size(h, k, stride), k12.out_size(w, k, stride)
    rng = np.random.default_rng(1)
    dp = torch.from_numpy(rng.standard_normal((b, oh * ow, k * k * c),
                                              np.float32))
    got = F.fold(chip_smoke.fold_input(dp, k, k), output_size=(h, w),
                 kernel_size=k, stride=stride).permute(0, 2, 3, 1)
    want = k12.col2im_patches_plain(dp, kh=k, kw=k, stride=stride, h=h, w=w)
    # At most ceil(k/stride)^2 = 81 taps summed in another order.
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
