"""The plain reference of benchmark/reference/ against the port at small
widths on the CPU, the same weights drawn by benchmark/weights.py into
both, the port computing in float32: each layer the comparison covers
(SEAN's encode and decode, folded and not, in eval and train mode; the
EigenGAN feature; the mask decoders' logits; the blend; the colour maps;
the slider and sweep latents; a whole edit; SEAN's training step)."""

import numpy as np
import pytest
import torch

from benchmark import inputs, weights
from benchmark.drivers import edit as driver
from benchmark.reference import edit as ref
from benchmark.reference import sean as ref_sean
from benchmark.reference import sean_train as ref_train
from benchmark.reference.nn import sub
from benchmark.tests.helpers import edit_config, train_config

from ctrlhair_tpu_torch.config import SEANConfig
from ctrlhair_tpu_torch.models.layers import set_train
from ctrlhair_tpu_torch.models.sean import SEAN
from ctrlhair_tpu_torch.pipeline import latent as port_latent
from ctrlhair_tpu_torch.pipeline.backend import Backend
from ctrlhair_tpu_torch.pipeline.editor import HairEditor
from ctrlhair_tpu_torch.ui import app
from ctrlhair_tpu_torch.utils import colorspace

SEED = 2 ** 35 + 3


@pytest.fixture(scope='module')
def setup():
    cfg = edit_config('tiny')['pipeline']
    cfg['compute_dtype'] = 'float32'
    pc = driver.pipeline_config(cfg)
    editor = HairEditor(pc, device='cpu')
    specs = weights.specs_of(editor.state_dict())
    editor.load_state_dict(weights.draw(specs, SEED, 'cpu'))
    p = weights.draw(specs, SEED, 'cpu')
    rng = np.random.default_rng(1)
    face, label = inputs.session_face(pc.edit_size, rng, 'cpu')
    lat = inputs.latent(rng, driver.latent_dims(pc))
    return cfg, pc, editor, p, face, label, lat


def close(a, b, tol):
    scale = max(float(b.abs().max()), 1e-6)
    assert float((a - b).abs().max()) <= tol * scale


@pytest.mark.parametrize('fold', [True, False])
@pytest.mark.parametrize('train', [False, True])
def test_sean_encode_decode(setup, fold, train):
    cfg, _, _, p, face, label, _ = setup
    scfg = dict(cfg['sean'], fold_style_convs=fold)
    sean = SEAN(SEANConfig(**scfg))
    sean.load_state_dict(sub(p, 'sean.'))
    set_train(sean, train)
    img = face[None].float() / 127.5 - 1.0
    with torch.no_grad():
        codes = sean.encode(img, label[None])
        close(ref_sean.encode(sub(p, 'sean.'), scfg, img, label[None]),
              codes, 1e-5)
        out = sean.decode(label[None], codes)
        close(ref_sean.decode(sub(p, 'sean.'), scfg, label[None], codes,
                              train=train), out, 1e-4)


def test_feature_and_mask_logits(setup):
    cfg, _, editor, p, _, _, lat = setup
    lt = {k: torch.as_tensor(v) for k, v in lat.items()}
    with torch.no_grad():
        close(ref.hair_feature(p, cfg['color_texture'], lt),
              editor._feature(port_latent.Latent(**lt)), 1e-5)
        hair, face = editor.shape.decode_logits(lt['shape'], lt['face'])
        merged = torch.cat([face[..., :13], hair, face[..., 13:]], -1)
        close(ref.mask_logits(p, cfg['shape'], lt['shape'], lt['face']),
              merged.permute(0, 3, 1, 2), 1e-4)


def test_label_gap():
    logits = torch.tensor([[[[1.0]], [[3.0]], [[2.5]]]])
    assert ref.label_gap(logits, torch.tensor([[[1]]])) == 0.0
    assert ref.label_gap(logits, torch.tensor([[[2]]])) == 0.5
    assert ref.label_gap(logits, torch.tensor([[[255]]])) == float('inf')


def test_blend(setup):
    cfg, pc, editor, _, face, label, _ = setup
    gen = torch.tanh(torch.randn(1, pc.edit_size, pc.edit_size, 3,
                                 generator=torch.Generator().manual_seed(0)))
    target = torch.roll(label, 5, dims=0)[None]
    with torch.no_grad():
        got = editor._blend(face[None], gen, label[None], target)
    want = ref.blend(face[None], gen, label[None], target,
                     cfg['poisson_iterations'])
    assert int((got.int() - want.int()).abs().max()) <= 1


def test_colour_maps():
    g = torch.Generator().manual_seed(2)
    hsv = torch.stack([torch.randint(0, 180, (4096,), generator=g),
                       torch.randint(0, 256, (4096,), generator=g),
                       torch.randint(0, 256, (4096,), generator=g)],
                      -1).float()
    assert torch.equal(ref.hsv_to_rgb(hsv),
                       colorspace.hsv_to_rgb_u8(hsv).float())
    rgb = torch.rand(4096, 3, generator=g) * 255
    assert torch.equal(ref.rgb_to_hsv(rgb),
                       colorspace.rgb_to_hsv_u8(rgb).float())


def session(setup):
    cfg, pc, editor, _, face, label, lat = setup
    rng = np.random.default_rng(3)
    sdirs = inputs.directions(rng, 16, 4)
    tdirs = inputs.directions(rng, 8, 2)
    be = Backend(cfg=pc, editor=editor, hsv_table=inputs.hsv_table(),
                 trained_root='/nonexistent/weights', blending=True)
    be.shape_dirs, be.texture_dirs = list(sdirs), list(tdirs)
    driver.open_session(be, editor, face, label, lat, torch.device('cpu'))
    return be, sdirs, tdirs


def test_slider_replay_and_edit(setup):
    cfg, _, editor, p, face, label, lat = setup
    be, sdirs, tdirs = session(setup)
    table = torch.as_tensor(inputs.hsv_table())
    lt = {k: torch.as_tensor(v) for k, v in lat.items()}
    codes = ref_sean.encode(sub(p, 'sean.'), cfg['sean'],
                            face[None].float() / 127.5 - 1.0, label[None])
    rng = np.random.default_rng(4)
    for group, _, idx in app.SLIDER_SPECS:
        tick = (group, idx, float(rng.uniform(-2.5, 2.5)))
        app.apply_slider(be, *tick)
        out = be.output()
        lt = ref.apply_tick(lt, tick, table, torch.as_tensor(sdirs),
                            torch.as_tensor(tdirs))
        for k, v in lt.items():
            close(v, getattr(be.cur_latent, k), 1e-6)
        mask = torch.as_tensor(be.cur_mask)[None]
        logits = ref.mask_logits(p, cfg['shape'], lt['shape'], lt['face'])
        assert ref.label_gap(logits, mask) < 1e-4
        want = ref.edit(p, cfg, codes, lt, face[None], label[None], mask)
        diff = (torch.as_tensor(out)[None].int() - want.int()).abs()
        assert float(diff.float().mean()) < 0.05


def test_sweep_latents(setup):
    _, pc, _, _, _, _, lat = setup
    rng = np.random.default_rng(5)
    l2 = inputs.latent(rng, driver.latent_dims(pc))
    a = torch.linspace(0, 1, 8)
    l1t = {k: torch.as_tensor(v) for k, v in lat.items()}
    l2t = {k: torch.as_tensor(v) for k, v in l2.items()}
    got = port_latent.interpolate(port_latent.Latent(**l1t),
                                  port_latent.Latent(**l2t), a[:, None])
    want = ref.interpolate(l1t, l2t, a)
    for k in want:
        close(want[k], getattr(got, k).expand_as(want[k]), 1e-6)


def test_training_step():
    from ctrlhair_tpu_torch.training.chunked import ChunkRunner
    from ctrlhair_tpu_torch.training.sean_trainer import SEANTrainer
    from benchmark.drivers import sean_train as tdriver
    cfg = train_config()
    tr = cfg['trainer']
    trainer = SEANTrainer(SEANConfig(**cfg['sean']), device='cpu',
                          **{k: tr[k] for k in tdriver.TRAINER_ARGS})
    state = trainer.init_state()
    specs = (weights.specs_of(state.gen.module.state_dict(), 'sean.')
             + weights.specs_of(state.dis.module.state_dict(), 'dis.')
             + weights.specs_of(trainer.vgg.state_dict(), 'vgg.'))
    p0 = weights.draw(specs, SEED, 'cpu')
    state.gen.module.load_state_dict(sub(p0, 'sean.'))
    state.dis.module.load_state_dict(sub(p0, 'dis.'))
    trainer.vgg.load_state_dict(sub(p0, 'vgg.'))
    u = {**{'sean.' + k: v for k, v in state.sn_u.items()},
         **{'dis.' + k: v for k, v in state.dis_sn_u.items()}}
    u0 = weights.unit_vectors({k: v.numel() for k, v in u.items()}, 9, 'cpu')
    for k, v in u.items():
        v.copy_(u0[k])
    g = torch.Generator().manual_seed(6)
    s = cfg['sean']['crop_size']
    batches = [{'image': torch.rand(4, s, s, 3, generator=g) * 2 - 1,
                'label': torch.randint(0, 19, (4, s, s), generator=g,
                                       dtype=torch.int32)}
               for _ in range(2)]
    runner = ChunkRunner(trainer.train_step, lambda i: batches[i])
    state, rows, _ = runner.run(state, 0, 2, chunk_size=2, record_every=1)
    st = ref_train.State(p0, u0)
    grads = None
    for row, b in zip(rows, batches):
        r = ref_train.step(st, cfg, b)
        grads = grads or tdriver.leaf_norms(st.mu)
        for key in ('g_total', 'd_total'):
            assert abs(row[key] - r[key]) <= 1e-5 * abs(r[key])
    live = {**{'sean.' + k: v for k, v in
               state.gen.module.named_parameters()},
            **{'dis.' + k: v for k, v in
               state.dis.module.named_parameters()}}
    # Adam with beta1 0 moves each entry by about lr * sign(gradient), and
    # an entry whose gradient is near eps parts by rounding: the changes
    # are held by their norms, as the cell holds them
    norm = lambda t: float(torch.linalg.vector_norm(t.double()))
    port = {k: norm(v.detach() - p0[k]) for k, v in live.items()}
    want = {k: norm(st.p[k] - p0[k]) for k in live}
    med = float(np.median(list(want.values())))
    skip = tdriver.excluded(grads)
    assert 0 < len(skip) < len(live) // 4
    for k in set(live) - skip:
        assert abs(port[k] - want[k]) <= 0.05 * max(want[k], med), k
    for k, v in u.items():
        close(st.u[k], v, 1e-3)
