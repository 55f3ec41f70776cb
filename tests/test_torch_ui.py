# The port's frontends (ui/app.py, ui/web.py, ui/demo.py) against the JAX
# package's on the same weights and inputs: the slider tables and tick maths
# (equal), slider dispatch and read-back on both Backends (within 1e-4), the
# headless demo (images within 1 uint8 step on >= 99.9% of pixels), and both
# web servers over real HTTP with one request script: /state within 1e-4 a
# slider, the same status codes, /image/output within the image bar; one
# request renders with blending on, so the masked CG's plain version runs.
# Also: no request records an autograd graph, and the entry points refuse
# to start without a card unless asked for the CPU.
import json
import os
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from ctrlhair_tpu.pipeline.backend import Backend as JaxBackend
from ctrlhair_tpu.ui import app as japp
from ctrlhair_tpu.ui import demo as jdemo
from ctrlhair_tpu.ui.web import WebEditor as JaxWebEditor
from ctrlhair_tpu_torch.convert import from_flax
from ctrlhair_tpu_torch.pipeline.backend import Backend
from ctrlhair_tpu_torch.pipeline.editor import HairEditor
from ctrlhair_tpu_torch.ui import app, demo, web
from ctrlhair_tpu_torch.utils.image import decode_png, read_rgb, write_rgb
from test_torch_backend import images_agree, sample_photos
from test_torch_convert import port_config

SEED = 3
TOL = 1e-4


@pytest.fixture(scope='module')
def port(tiny_editor):
    ed = HairEditor(port_config(tiny_editor.cfg), device='cpu')
    ed.load_state_dict(from_flax(jax.device_get(tiny_editor.params)))
    return ed


@pytest.fixture(scope='module')
def photos(tmp_path_factory):
    """samples/input.png and its mirror image, as PNG paths."""
    mirror = str(tmp_path_factory.mktemp('photos') / 'mirror.png')
    write_rgb(mirror, sample_photos()[1])
    return JaxBackend._repo_path('samples/input.png'), mirror


# ------------------------------------------------------------ slider maths
def test_slider_tables_equal():
    assert app.SLIDER_SPECS == japp.SLIDER_SPECS
    for ticks in range(-250, 251, 7):
        assert app.slider_to_value(ticks, 2.5) == \
            japp.slider_to_value(ticks, 2.5)
    for v in np.linspace(-2.5, 2.5, 41):
        assert app.value_to_slider(v) == japp.value_to_slider(v)


def test_apply_and_read_sliders_match_jax(tiny_editor, port, photos):
    img = read_rgb(photos[0])
    jb = JaxBackend(maximum_value_fe=2.5, blending=False, cfg=tiny_editor.cfg,
                    editor=tiny_editor, seed=SEED)
    tb = Backend(maximum_value_fe=2.5, blending=False, cfg=port.cfg,
                 editor=port, seed=SEED)
    moves = [('color', 3, 1.0), ('curliness', 0, 0.5), ('texture', 0, -0.75),
             ('texture', 1, 0.3), ('shape', 1, 1.5), ('shape', 3, -0.4),
             ('color', 0, 0.8), ('color', 2, -1.1)]
    for be in (jb, tb):
        be.set_input_img(img)
    for group, idx, val in [(None, None, None)] + moves:
        if group is not None:
            japp.apply_slider(jb, group, idx, val)
            app.apply_slider(tb, group, idx, val)
        got, ref = app.read_sliders(tb), japp.read_sliders(jb)
        assert got.keys() == ref.keys() and len(got) == 11
        for k in ref:
            assert isinstance(got[k], float)
            assert abs(got[k] - ref[k]) < TOL, (group, idx, k, got[k], ref[k])
    got = app.read_sliders(tb)
    for group, idx, val in (('color', 3, 1.0), ('curliness', 0, 0.5),
                            ('texture', 1, 0.3), ('shape', 3, -0.4)):
        assert abs(got[(group, idx)] - val) < 1e-3


# --------------------------------------------------------------- the demo
def test_headless_demo_matches_jax(tiny_editor, port, photos, tmp_path,
                                   monkeypatch):
    """Both demos on fresh Backends over the same weights, blending on."""
    monkeypatch.setattr(
        'ctrlhair_tpu.pipeline.backend.Backend',
        lambda **kw: JaxBackend(cfg=tiny_editor.cfg, editor=tiny_editor,
                                seed=SEED, **kw))
    made = []

    def port_backend(**kw):
        assert kw['device'] == 'cpu' and kw['blending']
        made.append(Backend(cfg=port.cfg, editor=port, seed=SEED, **kw))
        return made[-1]

    monkeypatch.setattr('ctrlhair_tpu_torch.pipeline.backend.Backend',
                        port_backend)
    args = ['--input', photos[0], '--target', photos[1]]
    ref = jdemo.main(['--headless', str(tmp_path / 'jax.png')] + args)
    got = demo.main(['--headless', str(tmp_path / 'port.png'),
                     '--device', 'cpu'] + args)
    assert len(made) == 1 and made[0].maximum_value_fe == 2.0
    assert got.shape == (64, 64, 3)
    images_agree(got, ref, 'demo output')
    np.testing.assert_array_equal(read_rgb(str(tmp_path / 'port.png')), got)
    images_agree(read_rgb(str(tmp_path / 'port.png')),
                 read_rgb(str(tmp_path / 'jax.png')), 'demo file')


def test_entry_points_need_a_card_or_cpu(monkeypatch, tmp_path, capsys):
    """No card and no --device: both exit with an error, build nothing."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    monkeypatch.setattr('ctrlhair_tpu_torch.pipeline.backend.Backend',
                        lambda **kw: pytest.fail('a Backend was built'))
    for main, argv in ((demo.main, ['--headless', str(tmp_path / 'o.png')]),
                       (web.main, ['--port', '0'])):
        with pytest.raises(SystemExit) as exc:
            main(argv)
        assert exc.value.code == 2
        assert '--device cpu' in capsys.readouterr().err
    assert not os.path.exists(tmp_path / 'o.png')


# ------------------------------------------------------------ web servers
def _serve(editor):
    srv = editor.make_server(port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f'http://127.0.0.1:{srv.server_address[1]}'


def _request(base, path, payload=None, raw=None):
    """(status, body) of one GET (payload None) or POST."""
    data = raw if raw is not None else (
        None if payload is None else json.dumps(payload).encode())
    req = urllib.request.Request(base + path, data=data,
                                 method='GET' if data is None else 'POST')
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _script(photos):
    """The request script: (name, path, payload or None, raw body)."""
    steps = [('page', '/', None, None),
             ('state_empty', '/state', None, None),
             ('load_input', '/load', {'path': photos[0], 'which': 'input'},
              None),
             ('load_target', '/load', {'path': photos[1], 'which': 'target'},
              None),
             ('state_loaded', '/state', None, None)]
    values = (0.7, -0.4, 1.2, 0.5, 0.6, -0.8, 0.9, 1.1, -0.6, 0.3, -1.0)
    for (group, _, idx), val in zip(app.SLIDER_SPECS, values):
        steps.append((f'slider_{group}_{idx}', '/slider',
                      {'group': group, 'idx': idx, 'value': val}, None))
    steps += [('state_sliders', '/state', None, None),
              ('transfer_color', '/transfer', {'arg': 'color'}, None),
              ('transfer_texture', '/transfer', {'arg': 'texture'}, None),
              ('random_texture', '/random', {'arg': 'texture'}, None),
              ('random_curliness', '/random', {'arg': 'curliness'}, None),
              ('random_shape', '/random', {'arg': 'shape'}, None),
              ('state_random', '/state', None, None),
              ('output_noblend', '/image/output', None, None),
              ('blend', '/slider',                # with blending on
               {'group': 'color', 'idx': 1, 'value': -0.3}, None),
              ('state_final', '/state', None, None)]
    steps += [(f'image_{n}', f'/image/{n}', None, None)
              for n in ('input', 'mask', 'target', 'output')]
    steps += [('bad_image', '/image/nope', None, None),
              ('bad_get', '/nope', None, None),
              ('bad_json', '/slider', None, b'not json'),
              ('bad_post', '/nope', {'arg': 'color'}, None),
              ('bad_slider', '/slider', {'group': 'color'}, None),
              ('bad_load', '/load', {'path': photos[0] + '.absent'}, None)]
    return steps


def _run_script(base, editor, photos):
    out = {}
    for name, path, payload, raw in _script(photos):
        editor.backend.blending = name == 'blend'
        out[name] = _request(base, path, payload, raw)
    return out


@pytest.fixture(scope='module')
def served(tiny_editor, port, photos):
    """Both servers driven through the script; the port's built by
    ui.web.build_web_editor, as its main() builds it."""
    jax_editor = JaxWebEditor(JaxBackend(
        maximum_value_fe=2.0, blending=False, cfg=tiny_editor.cfg,
        editor=tiny_editor, seed=SEED), maximum_value_fe=2.0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr('ctrlhair_tpu_torch.pipeline.backend.Backend',
                   lambda **kw: Backend(cfg=port.cfg, editor=port, seed=SEED,
                                        **kw))
        port_editor = web.build_web_editor(2.0, False, 'cpu')
    grad_modes = []
    change_color = port_editor.backend.change_color

    def recording(*args):
        grad_modes.append((torch.is_grad_enabled(),
                           threading.current_thread().name))
        return change_color(*args)

    port_editor.backend.change_color = recording
    results = {}
    for name, editor in (('jax', jax_editor), ('port', port_editor)):
        srv, base = _serve(editor)
        try:
            results[name] = _run_script(base, editor, photos)
        finally:
            srv.shutdown()
            srv.server_close()
    port_editor.close()
    return results, port_editor, grad_modes


def test_web_status_codes_match_jax(served):
    results, _, _ = served
    got, ref = results['port'], results['jax']
    assert got.keys() == ref.keys()
    codes = {k: got[k][0] for k in got}
    assert codes == {k: ref[k][0] for k in ref}
    assert codes['bad_image'] == codes['bad_get'] == codes['bad_post'] == 404
    assert codes['bad_json'] == 400
    assert codes['bad_slider'] == codes['bad_load'] == 500
    assert all(v == 200 for k, v in codes.items() if not k.startswith('bad'))
    for k in ('bad_json', 'bad_slider', 'bad_image'):
        assert json.loads(got[k][1]).keys() == json.loads(ref[k][1]).keys()


def test_web_page_and_state_match_jax(served):
    results, _, _ = served
    got, ref = results['port'], results['jax']
    page = got['page'][1].decode()
    specs = json.loads(page.split('const SPECS = ')[1].split(';')[0])
    assert specs == [list(s) for s in app.SLIDER_SPECS]
    assert 'const LIM = 200;' in page and page.count('Transfer') == 3
    assert page.replace('CtrlHair (PyTorch)', 'CtrlHair TPU') == \
        ref['page'][1].decode()
    for k in [k for k in got if k.startswith('state')]:
        g, r = json.loads(got[k][1]), json.loads(ref[k][1])
        assert g.keys() == r.keys() and g['sliders'].keys() == \
            r['sliders'].keys(), k
        assert (g['has_input'], g['has_target']) == (r['has_input'],
                                                      r['has_target'])
        for s in r['sliders']:
            assert abs(g['sliders'][s] - r['sliders'][s]) < TOL, (k, s)
    assert len(json.loads(got['state_final'][1])['sliders']) == 11
    assert json.loads(got['state_empty'][1]) == {
        'sliders': {}, 'has_input': False, 'has_target': False}


def test_web_images_match_jax(served):
    results, port_editor, _ = served
    got, ref = results['port'], results['jax']
    for k in ('output_noblend', 'image_input', 'image_target', 'image_mask',
              'image_output'):
        images_agree(decode_png(got[k][1]), decode_png(ref[k][1]), k)
    # the served PNGs are the held arrays; the blended output differs from
    # the unblended one
    for n in ('input', 'mask', 'target', 'output'):
        np.testing.assert_array_equal(decode_png(got[f'image_{n}'][1]),
                                      port_editor.images[n])
    assert (decode_png(got['image_output'][1]) !=
            decode_png(got['output_noblend'][1])).any()


def test_web_requests_record_no_graph(served):
    """Handler threads start with grad mode on; every action runs on the
    editor's one worker thread with it off, so nothing a request computes
    carries a grad_fn."""
    _, port_editor, grad_modes = served
    assert len(grad_modes) == 5 and not any(g for g, _ in grad_modes)
    assert len({name for _, name in grad_modes}) == 1
    lat = port_editor.backend.cur_latent
    for f in ('hsv', 'pca_std', 'curliness', 'texture', 'shape', 'face'):
        t = getattr(lat, f)
        assert t.grad_fn is None and not t.requires_grad, f
    assert not any(p.requires_grad for p in port_editor.backend.editor
                   .parameters())


def test_web_load_refuses_jpeg(port, tmp_path):
    """/load refuses bytes that are no image it can decode: a JPEG cut off
    after its first marker answers 500 with the codec's message."""
    jpeg = tmp_path / 'photo.jpg'
    jpeg.write_bytes(b'\xff\xd8\xff\xe0\x00\x10JFIF\x00' + bytes(64))
    editor = web.WebEditor(Backend(cfg=port.cfg, editor=port, seed=SEED))
    srv, base = _serve(editor)
    try:
        code, body = _request(base, '/load', {'path': str(jpeg)})
    finally:
        srv.shutdown()
        srv.server_close()
        editor.close()
    assert code == 500 and 'JPEG' in json.loads(body)['error']
    assert editor.images['input'] is None


def test_web_load_palette_png_and_jpeg(port, tmp_path):
    """/load takes what the JAX UI's PIL reader takes: a palette PNG and a
    progressive JPEG of the sample answer 200, and each loads as an RGB PNG
    of PIL's convert('RGB') of it loads."""
    from PIL import Image
    photo = Image.open(JaxBackend._repo_path('samples/input.png'))
    paths = {'palette': tmp_path / 'palette.png',
             'jpeg': tmp_path / 'photo.jpg'}
    photo.convert('RGB').quantize(colors=64).save(paths['palette'])
    photo.convert('RGB').save(paths['jpeg'], quality=90, progressive=True)
    editor = web.WebEditor(Backend(cfg=port.cfg, editor=port, seed=SEED))
    srv, base = _serve(editor)
    try:
        for name, path in paths.items():
            rgb = tmp_path / f'{name}_rgb.png'
            write_rgb(str(rgb), np.asarray(Image.open(path).convert('RGB')))
            shown = []
            for p in (path, rgb):
                code, body = _request(base, '/load', {'path': str(p),
                                                      'which': 'input'})
                assert code == 200, body
                shown.append(editor.images['input'])
            np.testing.assert_array_equal(shown[0], shown[1])
    finally:
        srv.shutdown()
        srv.server_close()
        editor.close()
