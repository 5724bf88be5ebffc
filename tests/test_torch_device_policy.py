"""The port's f32 policy (core/device.py::use_full_f32) on the process-wide
backend flags: float32 turns TF32 off for matmuls and convolutions and lets
cuDNN choose each convolution's algorithm by measuring its first two
candidates; bfloat16 leaves every flag as it was. The flags are set the
same with or without a card."""

import pytest
import torch

from loco_edit_tpu_torch.core.device import use_full_f32


def _flags():
    b = torch.backends
    return (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32, b.cudnn.benchmark,
            b.cudnn.benchmark_limit)


def _set(matmul, cudnn, benchmark, limit):
    b = torch.backends
    (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32, b.cudnn.benchmark,
     b.cudnn.benchmark_limit) = matmul, cudnn, benchmark, limit


@pytest.fixture
def restored_flags():
    saved = _flags()
    yield
    _set(*saved)


@pytest.mark.parametrize("dtype, want", [
    (torch.float32, (False, False, True, 2)),
    (torch.bfloat16, None),                     # each flag as found
])
def test_use_full_f32_sets_the_f32_flags_and_leaves_bf16_alone(dtype, want, restored_flags):
    for found in ((True, True, False, 10), (False, False, True, 0)):
        _set(*found)
        use_full_f32(dtype)
        assert _flags() == (want or found)
