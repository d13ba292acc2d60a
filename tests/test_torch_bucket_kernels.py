"""The CUDA kernels that the serving pool runs at its largest bucket, eight
clips in one launch: the pooled stem (#2), the depthwise (#5) and the
stage chain (#8) against their plain versions, bit-equal to a repeat
launch, and each clip's output bit-equal whatever the other clips of the
batch hold (the pool fills a bucket's spare rows with zero clips and the
first stream's masks). The tolerances are those of test_torch_stem.py,
test_torch_depthwise.py and test_torch_stage.py. They need the card and
skip elsewhere:
  python -m pytest tests/test_torch_bucket_kernels.py -m cuda --noconftest
"""

import pytest
import torch
from torch_fixtures import one_torch_thread  # noqa: F401
from test_torch_depthwise import _inputs as dw_inputs
from test_torch_stage import _stream_on
from test_torch_stem import _inputs as stem_inputs

from tubelet_transformer_tpu_torch.ops.cuda import depthwise as D
from tubelet_transformer_tpu_torch.ops.cuda import stage as S
from tubelet_transformer_tpu_torch.ops.cuda import stem

pytestmark = pytest.mark.usefixtures("one_torch_thread")

B = 8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rows_independent(fn, x, *rest):
    """Each clip of ``fn(x, *rest)`` bit-equal with every other clip
    replaced (by x's clips in reverse order, and by zeros)."""
    want = fn(x, *rest)
    for filler in (x.flip(0), torch.zeros_like(x)):
        for i in range(x.shape[0]):
            other = filler.clone()
            other[i] = x[i]
            if not torch.equal(fn(other, *rest)[i], want[i]):
                return False
    return True


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(B, 4, 64, 64, 3), (B, 3, 37, 45, 3)])
def test_stem_at_eight_clips_on_cuda(cuda, shape):
    x, w, scale, bias = stem_inputs(shape, seed=1)
    x, w = (torch.from_numpy(a).to(cuda, torch.bfloat16) for a in (x, w))
    scale, bias = (torch.from_numpy(a).to(cuda) for a in (scale, bias))
    launches = stem.LAUNCHES
    got = stem.stem_forward(x, w, scale, bias)
    again = stem.stem_forward(x, w, scale, bias)
    torch.cuda.synchronize()
    assert stem.LAUNCHES == launches + 2 and torch.equal(got, again)
    want = stem.stem_reference(x, w, scale, bias)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 2.0 ** -6 * want.float().abs().max().item()
    assert _rows_independent(stem.stem_forward, x, w, scale, bias)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(B, 8, 32, 32, 64), (B, 5, 7, 9, 72)])
def test_depthwise_at_eight_clips_on_cuda(cuda, shape):
    x, w, _, _ = (torch.from_numpy(a).to(cuda) for a in dw_inputs(shape, 2))
    x, w = x.to(torch.bfloat16), w.to(torch.bfloat16)
    launches = D.LAUNCHES
    got = D.depthwise_conv3x3x3(x, w)
    again = D.depthwise_conv3x3x3(x, w)
    torch.cuda.synchronize()
    assert D.LAUNCHES == launches + 2 and torch.equal(got, again)
    want = D.depthwise_reference(x, w)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 2.0 ** -6 * want.float().abs().max().item()
    assert _rows_independent(D.depthwise_conv3x3x3, x, w)


@pytest.mark.cuda
@pytest.mark.parametrize("cm,shape", [(128, (B, 4, 16, 16, 512)),
                                      (512, (B, 2, 8, 8, 2048))])
def test_chain_at_eight_clips_on_cuda(cuda, cm, shape):
    args = _stream_on(cuda, 3, shape, cm, torch.bfloat16)
    launches = S.LAUNCHES
    got = S.bottleneck_chain(*args)
    again = S.bottleneck_chain(*args)
    torch.cuda.synchronize()
    assert S.LAUNCHES == launches + 2 and torch.equal(got, again)
    want = S.chain_reference_rounded(args[0], args[1:])
    scale = want.abs().max()
    for bi in range(B):
        assert (got[bi].float() - want[bi]).abs().max() < 5e-3 * scale, bi
    assert _rows_independent(S.bottleneck_chain, *args)
