# Browser-based editing frontend (stdlib HTTP, zero extra dependencies).
#
# Port of ctrlhair_tpu/ui/web.py, on the torch Backend.  Functional parity
# with the reference PyQt GUI (ref: ui/frontend_demo.py:52-259): four image
# panes, eleven sliders, transfer / random buttons — served as a single
# HTML page talking JSON to a ThreadingHTTPServer.  The routes, JSON schema
# and status codes are the JAX twin's; the widget layout and
# slider->Backend dispatch semantics are shared with ui/app.py
# (SLIDER_SPECS / apply_slider / read_sliders).  Images go out as PNG from
# the port's own codec; /load reads PNG files only.
#
#   python -m ctrlhair_tpu_torch.ui.web --input samples/input.png
#
# runs the full-width editor on the first CUDA device (--device cpu runs it
# on the CPU; without a card and without that flag it exits with an error).
# The server accepts requests at once; the editor's worker thread first
# warms the interactive stages (HairEditor.warm_start), as the JAX server
# warms its programs, and requests queue behind it.

from __future__ import annotations

import functools
import json
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

import numpy as np
import torch

from ctrlhair_tpu_torch.ui.app import SLIDER_SPECS, apply_slider, read_sliders
from ctrlhair_tpu_torch.utils.image import encode_png, read_rgb

_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>CtrlHair (PyTorch)</title>
<style>
 body {{ font-family: sans-serif; margin: 16px; background: #15171a;
        color: #e8e8e8; }}
 .panes {{ display: flex; gap: 12px; }}
 .pane {{ text-align: center; }}
 .pane img {{ width: 256px; height: 256px; background: #000;
             border: 1px solid #333; image-rendering: pixelated; }}
 .controls {{ margin-top: 12px; }}
 .row {{ display: flex; align-items: center; gap: 8px; margin: 3px 0; }}
 .row label {{ width: 180px; }}
 .row input[type=range] {{ flex: 1; }}
 button {{ margin-right: 6px; }}
</style></head>
<body>
<h2>CtrlHair (PyTorch)</h2>
<div class="panes">
  <div class="pane"><div>input</div><img id="pane-input"></div>
  <div class="pane"><div>mask</div><img id="pane-mask"></div>
  <div class="pane"><div>target</div><img id="pane-target"></div>
  <div class="pane"><div>output</div><img id="pane-output"></div>
</div>
<div class="controls">
  <input id="load-path" placeholder="server path to image" size="40">
  <button onclick="load('input')">Load input</button>
  <button onclick="load('target')">Load target</button>
  <span id="hint"></span>
</div>
<div class="controls">
  <button onclick="act('transfer','color')">Transfer color</button>
  <button onclick="act('transfer','texture')">Transfer texture</button>
  <button onclick="act('transfer','shape')">Transfer shape</button>
  <button onclick="act('random','texture')">Random texture</button>
  <button onclick="act('random','shape')">Random shape</button>
  <button onclick="act('random','curliness')">Random curliness</button>
</div>
<div class="controls" id="sliders"></div>
<script>
const LIM = {lim};
const SPECS = {specs};
function refreshImages(names) {{
  for (const n of (names || ['input','mask','target','output']))
    document.getElementById('pane-'+n).src = '/image/'+n+'?t='+Date.now();
}}
async function refreshState() {{
  const st = await (await fetch('/state')).json();
  document.getElementById('hint').textContent =
    st.has_input ? '' : 'load an input image to begin';
  if (!st.has_input) return;
  for (const [g, l, i] of SPECS) {{
    const el = document.getElementById('s-'+g+'-'+i);
    if (el && st.sliders[g+':'+i] !== undefined)
      el.value = Math.round(st.sliders[g+':'+i] * 100);
  }}
}}
async function onSlider(group, idx, ticks) {{
  await fetch('/slider', {{method:'POST',
    body: JSON.stringify({{group: group, idx: idx,
                           value: ticks / 100.0}})}});
  refreshImages(['mask', 'output']);   // input/target never change per tick
}}
async function act(kind, arg) {{
  await fetch('/'+kind, {{method:'POST',
                          body: JSON.stringify({{arg: arg}})}});
  await refreshState(); refreshImages(['mask', 'output']);
}}
async function load(which) {{
  const path = document.getElementById('load-path').value;
  const r = await fetch('/load', {{method:'POST',
    body: JSON.stringify({{path: path, which: which}})}});
  if (!r.ok) {{ const e = await r.json();
                document.getElementById('hint').textContent =
                  e.error || 'load failed'; return; }}
  await refreshState(); refreshImages();
}}
const holder = document.getElementById('sliders');
for (const [g, l, i] of SPECS) {{
  const row = document.createElement('div'); row.className = 'row';
  row.innerHTML = `<label>${{g}}:${{l}}</label>
    <input type="range" id="s-${{g}}-${{i}}" min="-${{LIM}}" max="${{LIM}}"
     value="0" onchange="onSlider('${{g}}', ${{i}}, this.value)">`;
  holder.appendChild(row);
}}
refreshState(); refreshImages();
</script></body></html>
"""


def _png_bytes(img: Optional[np.ndarray]) -> bytes:
    if img is None:
        img = np.zeros((8, 8, 3), np.uint8)
    return encode_png(np.asarray(img).astype(np.uint8))


def _on_worker(action):
    """Run a WebEditor action on the editor's worker thread, under its lock
    and torch.no_grad(), and return its result."""
    @functools.wraps(action)
    def call(self, *args):
        def run():
            with self.lock, torch.no_grad():
                return action(self, *args)
        return self._worker.submit(run).result()
    return call


def _report_failure(future) -> None:
    """Print the error of the warm-up, whose result no request reads."""
    err = future.exception()
    if err is not None:
        print(f'web editor: the warm-up failed: {err!r}', file=sys.stderr,
              flush=True)


class WebEditor:
    """Backend session + HTTP endpoints; one lock serialises edits.

    The server starts a thread for each request, but every action runs on
    the one worker thread this editor owns: PyTorch keeps state per thread
    (grad mode, which a new thread starts with on, and caches of the card's
    libraries, which a new thread builds again), so each request would
    otherwise start cold.  Actions run under torch.no_grad(), so nothing a
    request computes records an autograd graph.  With warm=True the
    worker's first job is the editor's warm_start, so that the first
    request finds that thread's state built; requests queue behind it, and
    `warm` is its future (host ms).  close() stops the worker."""

    def __init__(self, backend, maximum_value_fe: float = 2.0,
                 warm: bool = False):
        self.backend = backend
        self.max_fe = maximum_value_fe
        self.lock = threading.Lock()
        self._worker = ThreadPoolExecutor(max_workers=1,
                                          thread_name_prefix='web-editor')
        self.images: Dict[str, Optional[np.ndarray]] = {
            'input': None, 'mask': None, 'target': None, 'output': None}
        self.warm = None
        if warm:
            self.warm = self._worker.submit(self._warm_up)
            self.warm.add_done_callback(_report_failure)

    def _warm_up(self) -> float:
        t0 = time.perf_counter()
        with self.lock, torch.no_grad():
            self.backend.editor.warm_start(block=True)
        return (time.perf_counter() - t0) * 1e3

    def join_warm(self) -> Optional[float]:
        """Wait for the warm-up; its host ms (None without one), or its
        error raised."""
        return None if self.warm is None else self.warm.result()

    def close(self) -> None:
        self._worker.shutdown()

    # ------------------------------------------------------------ actions
    @_on_worker
    def load_input(self, img: np.ndarray):
        shown, mask_rgb = self.backend.set_input_img(img)
        self.images['input'] = shown
        self.images['mask'] = mask_rgb

    @_on_worker
    def load_target(self, img: np.ndarray):
        shown, _ = self.backend.set_target_img(img)
        self.images['target'] = shown

    @_on_worker
    def slider(self, group: str, idx: int, value: float):
        apply_slider(self.backend, group, idx, value)
        self._render()

    @_on_worker
    def transfer(self, flag: str):
        self.backend.transfer_latent_representation(flag)
        self._render()

    @_on_worker
    def random(self, att: str):
        getattr(self.backend, f'get_random_{att}')()
        self._render()

    def _render(self):
        self.images['output'] = np.asarray(self.backend.output())
        self.images['mask'] = np.asarray(self.backend.get_cur_mask())

    @_on_worker
    def state(self) -> dict:
        # one host read a slider value: 11 synchronisations on a card
        sliders = ({} if self.backend.cur_latent is None else
                   {f'{g}:{i}': v
                    for (g, i), v in read_sliders(self.backend).items()})
        return {'sliders': sliders,
                'has_input': self.images['input'] is not None,
                'has_target': self.images['target'] is not None}

    # ------------------------------------------------------------- server
    def make_server(self, host: str = '127.0.0.1',
                    port: int = 0) -> ThreadingHTTPServer:
        editor = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def _send(self, code: int, body: bytes,
                      ctype: str = 'application/json'):
                self.send_response(code)
                self.send_header('Content-Type', ctype)
                self.send_header('Content-Length', str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                try:
                    self._do_get()
                except Exception as e:   # surface errors, keep serving
                    try:
                        self._send(500,
                                   json.dumps({'error': str(e)}).encode())
                    except Exception:
                        pass

            def _do_get(self):
                path = self.path.split('?')[0]
                if path == '/':
                    page = _PAGE.format(
                        lim=int(editor.max_fe * 100),
                        specs=json.dumps([[g, l, i]
                                          for g, l, i in SLIDER_SPECS]))
                    self._send(200, page.encode(), 'text/html')
                elif path == '/state':
                    self._send(200, json.dumps(editor.state()).encode())
                elif path.startswith('/image/'):
                    name = path[len('/image/'):]
                    if name not in editor.images:
                        self._send(404, b'{}')
                        return
                    self._send(200, _png_bytes(editor.images[name]),
                               'image/png')
                else:
                    self._send(404, b'{}')

            def do_POST(self):
                length = int(self.headers.get('Content-Length', '0'))
                try:
                    payload = json.loads(self.rfile.read(length) or b'{}')
                except json.JSONDecodeError:
                    self._send(400, b'{"error": "bad json"}')
                    return
                try:
                    if self.path == '/slider':
                        editor.slider(str(payload['group']),
                                      int(payload['idx']),
                                      float(payload['value']))
                    elif self.path == '/transfer':
                        editor.transfer(str(payload['arg']))
                    elif self.path == '/random':
                        editor.random(str(payload['arg']))
                    elif self.path == '/load':
                        img = read_rgb(str(payload['path']))
                        if payload.get('which') == 'target':
                            editor.load_target(img)
                        else:
                            editor.load_input(img)
                    else:
                        self._send(404, b'{}')
                        return
                except Exception as e:   # surface errors to the client
                    self._send(500, json.dumps({'error': str(e)}).encode())
                    return
                self._send(200, b'{"ok": true}')

        return ThreadingHTTPServer((host, port), Handler)


def build_web_editor(max_fe: float = 2.0, blending: bool = True,
                     device=None, input_path: Optional[str] = None,
                     target_path: Optional[str] = None) -> WebEditor:
    """The server's session as `main` builds it: Backend() (the full-width
    editor on `device`, the first CUDA device by default, booted from
    model_trained/) behind a WebEditor whose worker warms first, with the
    input and target photos loaded when given (behind the warm-up)."""
    from ctrlhair_tpu_torch.pipeline.backend import Backend
    backend = Backend(maximum_value_fe=max_fe, blending=blending,
                      device=device)
    editor = WebEditor(backend, maximum_value_fe=max_fe, warm=True)
    if input_path:
        editor.load_input(read_rgb(input_path))
    if target_path:
        editor.load_target(read_rgb(target_path))
    return editor


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description='CtrlHair web UI (PyTorch)')
    ap.add_argument('--port', type=int, default=8099)
    ap.add_argument('--host', default='127.0.0.1')
    ap.add_argument('--input', default=None)
    ap.add_argument('--target', default=None)
    ap.add_argument('--no-blending', action='store_true')
    ap.add_argument('--max-fe', type=float, default=2.0,
                    help='slider range, shared by backend and frontend '
                         '(ref frontend_demo.py:37)')
    ap.add_argument('--device', default=None,
                    help="torch device of the editor (default: the first "
                         "CUDA device; 'cpu' runs on the CPU)")
    args = ap.parse_args(argv)
    if args.device is None and not torch.cuda.is_available():
        ap.error("no CUDA device is available; pass --device cpu to run "
                 "on the CPU")

    editor = build_web_editor(args.max_fe, not args.no_blending,
                              args.device, args.input, args.target)
    server = editor.make_server(args.host, args.port)
    print(f'serving on http://{args.host}:{server.server_address[1]}/',
          flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()
        editor.close()


if __name__ == '__main__':
    main()
