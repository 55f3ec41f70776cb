# Interactive editing GUI (tkinter).
#
# Port of ctrlhair_tpu/ui/app.py, on the torch Backend.  Functional parity
# with the reference's PyQt frontend (ref: ui/frontend_demo.py:52-259): four
# image panes (input / current mask / target / output), eleven sliders —
# colour H, S, V, variance; curliness; texture smoothness/thickness; four
# shape axes — three transfer buttons, random-sample buttons, and load
# dialogs.  Slider range is [-max_fe, +max_fe] scaled x100 ticks (ref
# :37,119-120).  The widget layer is tkinter, imported only when an
# EditorApp is built; images reach Tk as PNG bytes from the port's own
# codec.  The slider tables and dispatch are shared with ui/web.py.  Load
# dialogs read PNG files (utils/image.read_rgb).

from __future__ import annotations

import base64
from typing import Dict, List, Optional, Tuple

import numpy as np

from ctrlhair_tpu_torch.utils.image import encode_png, read_rgb
from ctrlhair_tpu_torch.utils.profiling import span

SLIDER_SPECS: List[Tuple[str, str, int]] = [
    # (group, label, index) — labels follow ref ui/frontend_demo.py:104-109
    ('color', 'hue', 0),
    ('color', 'saturation', 1),
    ('color', 'brightness', 2),
    ('color', 'variance', 3),
    ('curliness', 'curliness', 0),
    ('texture', 'smoothness', 0),
    ('texture', 'thickness', 1),
    ('shape', 'length', 0),
    ('shape', 'volume', 1),
    ('shape', 'bangs_direction', 2),
    ('shape', 'bangs', 3),
]


def slider_to_value(ticks: int, maximum_value_fe: float) -> float:
    """Integer slider ticks (+-100*max) -> latent value."""
    return ticks / 100.0


def value_to_slider(value: float) -> int:
    return int(round(float(value) * 100))


def apply_slider(backend, group: str, idx: int, value: float) -> None:
    """Dispatch one slider move to the Backend (ref :233-259); a request
    root of the program's spans (a shape move decodes its mask here)."""
    with span('slider.apply'):
        if group == 'color':
            backend.change_color(value, idx)
        elif group == 'curliness':
            backend.change_curliness(value)
        elif group == 'texture':
            backend.change_texture(value, idx)
        elif group == 'shape':
            backend.change_shape(value, idx)


def read_sliders(backend) -> Dict[Tuple[str, int], float]:
    """Back-end latents -> slider values for refresh (ref :211-231)."""
    out: Dict[Tuple[str, int], float] = {}
    c0, c1, c2, var = backend.get_color_be2fe()
    out[('color', 0)], out[('color', 1)] = float(c0), float(c1)
    out[('color', 2)], out[('color', 3)] = float(c2), float(var)
    out[('curliness', 0)] = float(backend.get_curliness_be2fe())
    tex = backend.get_texture_be2fe()
    out[('texture', 0)], out[('texture', 1)] = map(float, tex)
    shp = backend.get_shape_be2fe()
    for i in range(4):
        out[('shape', i)] = float(shp[i])
    return out


class EditorApp:
    """tkinter application wrapping a Backend session."""

    def __init__(self, backend, maximum_value_fe: float = 2.0):
        import tkinter as tk
        self.tk = tk
        self.backend = backend
        self.max_fe = maximum_value_fe
        self.root = tk.Tk()
        self.root.title('CtrlHair (PyTorch)')
        self._panes: Dict[str, object] = {}
        self._photo = {}
        self._sliders: Dict[Tuple[str, int], object] = {}
        self._build()

    # ------------------------------------------------------------ layout
    def _build(self):
        tk = self.tk
        top = tk.Frame(self.root)
        top.pack(side=tk.TOP)
        for name in ('input', 'mask', 'target', 'output'):
            frame = tk.LabelFrame(top, text=name)
            frame.pack(side=tk.LEFT, padx=4, pady=4)
            # size via a black placeholder image: tk.Label width/height
            # ints are TEXT units (chars/lines) for an image-less label
            ph = tk.PhotoImage(width=256, height=256)
            lbl = tk.Label(frame, image=ph)
            lbl._placeholder = ph   # keep a reference alive
            lbl.pack()
            self._panes[name] = lbl

        btns = tk.Frame(self.root)
        btns.pack(side=tk.TOP)
        tk.Button(btns, text='Load input',
                  command=self._load_input).pack(side=tk.LEFT)
        tk.Button(btns, text='Load target',
                  command=self._load_target).pack(side=tk.LEFT)
        for flag in ('color', 'texture', 'shape'):
            tk.Button(btns, text=f'Transfer {flag}',
                      command=lambda f=flag: self._transfer(f)
                      ).pack(side=tk.LEFT)
        for att in ('texture', 'shape', 'curliness'):
            tk.Button(btns, text=f'Random {att}',
                      command=lambda a=att: self._random(a)
                      ).pack(side=tk.LEFT)

        sliders = tk.Frame(self.root)
        sliders.pack(side=tk.TOP, fill=tk.X)
        lim = int(self.max_fe * 100)
        for group, label, idx in SLIDER_SPECS:
            row = tk.Frame(sliders)
            row.pack(fill=tk.X)
            tk.Label(row, text=f'{group}:{label}', width=20,
                     anchor='w').pack(side=tk.LEFT)
            s = tk.Scale(row, from_=-lim, to=lim, orient=tk.HORIZONTAL,
                         length=420, showvalue=True)
            s.bind('<ButtonRelease-1>',
                   lambda _e, g=group, i=idx, w=None: self._on_slider(g, i))
            s.pack(side=tk.LEFT, fill=tk.X, expand=True)
            self._sliders[(group, idx)] = s

    # ------------------------------------------------------------ actions
    def _show(self, name: str, img: np.ndarray):
        """Show a uint8 image in its 256 px pane: a nearest resize, then the
        PNG bytes straight into Tk (Tk 8.6 reads PNG; no PIL)."""
        img = np.asarray(img).astype(np.uint8)
        ys = np.arange(256) * img.shape[0] // 256
        xs = np.arange(256) * img.shape[1] // 256
        data = base64.b64encode(encode_png(img[ys][:, xs])).decode('ascii')
        photo = self.tk.PhotoImage(data=data, format='png')
        self._photo[name] = photo
        self._panes[name].configure(image=photo)

    def _load_path(self) -> Optional[str]:
        from tkinter import filedialog
        return filedialog.askopenfilename() or None

    def _load_input(self, path: Optional[str] = None):
        path = path or self._load_path()
        if not path:
            return
        img, mask_rgb = self.backend.set_input_img(read_rgb(path))
        self._show('input', img)
        self._show('mask', mask_rgb)
        self.refresh_sliders()

    def _load_target(self, path: Optional[str] = None):
        path = path or self._load_path()
        if not path:
            return
        img, _ = self.backend.set_target_img(read_rgb(path))
        self._show('target', img)

    def _transfer(self, flag: str):
        self.backend.transfer_latent_representation(flag)
        self.refresh_sliders()
        self._render()

    def _random(self, att: str):
        getattr(self.backend, f'get_random_{att}')()
        self.refresh_sliders()
        self._render()

    def _on_slider(self, group: str, idx: int):
        val = slider_to_value(self._sliders[(group, idx)].get(), self.max_fe)
        apply_slider(self.backend, group, idx, val)
        self._render()

    def _render(self):
        out = self.backend.output()
        self._show('output', out)
        self._show('mask', self.backend.get_cur_mask())

    def refresh_sliders(self):
        for key, val in read_sliders(self.backend).items():
            self._sliders[key].set(value_to_slider(val))

    def run(self):
        self.root.mainloop()
