# Card-only tests of the PyTorch port: the masked-CG CUDA kernel against its
# plain version, and the float32 slice on the card against the same slice
# on the CPU.  They skip without a CUDA device.  This file imports nothing of
# JAX, so on a machine with a card and no JAX it runs without the suite's
# conftest:
#     python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
import numpy as np
import pytest
import torch

from ctrlhair_tpu_torch import config as C
from ctrlhair_tpu_torch.ops.poisson import blend_system, decode_solution
from ctrlhair_tpu_torch.ops.poisson_pallas import (
    MASKED_CG, masked_cg, masked_cg_plain)
from ctrlhair_tpu_torch.pipeline.editor import HairEditor


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda', 0)


@pytest.mark.cuda
@pytest.mark.parametrize('n', [1, 3])
def test_masked_cg_kernel_matches_plain(card, n):
    """At the main path's shape, float32: within 0.5 on [0,255] after the
    decode, pinned pixels equal to the target within 6e-3."""
    rng = np.random.default_rng(n)
    src = torch.tensor(rng.uniform(0, 255, (n, 256, 256, 3)),
                       dtype=torch.float32, device=card)
    tgt = torch.tensor(rng.uniform(0, 255, (n, 256, 256, 3)),
                       dtype=torch.float32, device=card)
    mask = torch.ones((n, 256, 256), device=card)
    mask[:, 64:192, 64:192] = 0.0
    b, u, x0, fixed, tgt_s, gamma = blend_system(src, tgt, mask)
    before = MASKED_CG.launches
    got = decode_solution(masked_cg(b, u, x0, 200), fixed, tgt_s, gamma)
    torch.cuda.synchronize()
    assert MASKED_CG.launches == before + 1
    want = decode_solution(masked_cg_plain(b, u, x0, 200), fixed, tgt_s,
                           gamma)
    assert float((got - want).abs().max()) <= 0.5
    keep = fixed[:, 0]
    assert float((got[keep] - tgt[keep]).abs().max()) <= 6e-3


@pytest.mark.cuda
def test_tiny_slice_on_card_matches_cpu(card):
    cfg = C.PipelineConfig(
        sean=C.SEANConfig(crop_size=64, ngf=4, zencoder_ngf=4, style_dim=64),
        bisenet=C.BiSeNetConfig(input_size=128),
        color_texture=C.ColorTextureConfig(style_dim=64),
        shape=C.ShapeConfig(img_size=64, layer_num=5, max_channel=64,
                            hidden_in_channel=8),
        edit_size=64, poisson_iterations=60, compute_dtype='float32')
    gpu = HairEditor(cfg, device=card, seed=1)
    cpu = HairEditor(cfg, device='cpu', seed=1)
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (128, 128, 3), dtype=np.uint8)
    face = rng.integers(0, 256, (1, 64, 64, 3), dtype=np.uint8)
    ag, ac = gpu.analyze_image(img), cpu.analyze_image(img)
    assert (ag['label'].cpu() == ac['label']).float().mean() >= 0.999
    args = (ac['sean_codes'], ac['latent'], face, ac['label'],
            ac['regen_label'])
    before = MASKED_CG.launches
    got = gpu.output(*args).cpu().int()
    assert MASKED_CG.launches == before + 1
    d = (got - cpu.output(*args).int()).abs()
    assert (d <= 1).float().mean() >= 0.999
