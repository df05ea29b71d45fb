"""Fake ``gradio`` and ``viser`` modules for driving the interactive demo
(``serve/demo.py``) and the Viser server (``serve/viser_server.py``) of
either package without the real UI packages, which neither the CPU
machine nor the card has.

The fake Gradio records each ``Button.click`` and ``File.change`` wiring
on the open ``Blocks``; the fake Viser records the scene's point clouds
and camera frustums and gives every control a ``set`` / ``click`` that
fires its callbacks, as a browser would.  No JAX here: the port's tests
and ``chip_smoke.py`` (on the card, which has no JAX) both import it.

    from torch_fake_ui import fake_ui          # pytest fixture
    sys.modules.update(fake_modules())         # anywhere else

``sleepy_server`` is a trivial process target for the session manager.
"""

import sys
import types

import numpy as np
import pytest


# ---------------------------------------------------------------------------
# stub gradio
# ---------------------------------------------------------------------------

def make_fake_gradio():
    gr = types.ModuleType("gradio")

    class Component:
        def __init__(self, *a, **k):
            pass

    class Blocks:
        def __init__(self, *a, **k):
            self.clicks = []
            self.changes = []

        def __enter__(self):
            gr._current = self
            return self

        def __exit__(self, *a):
            gr._current = None

        def launch(self, **k):
            self.launched = True

    class Button(Component):
        def click(self, fn, inputs, outputs):
            gr._current.clicks.append((fn, inputs, outputs))

    class Row(Component):
        def __enter__(self):
            return self

        def __exit__(self, *a):
            pass

    class File(Component):
        def change(self, fn, inputs, outputs):
            gr._current.changes.append((fn, inputs, outputs))

    for name in ("Markdown", "Video", "Slider", "Model3D", "Textbox",
                 "Gallery", "Radio", "HTML", "State"):
        setattr(gr, name, type(name, (Component,), {}))
    gr.File = File
    gr.Blocks, gr.Button, gr.Row = Blocks, Button, Row
    gr.Request = object
    gr._current = None
    return gr


# ---------------------------------------------------------------------------
# stub viser (records scene objects; functional slider callback)
# ---------------------------------------------------------------------------

def _mat_to_wxyz(R):
    R = np.asarray(R, np.float64)
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s,
                         (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s])
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 1e-12)) * 2
    q = np.zeros(4)
    q[0] = (R[k, j] - R[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (R[j, i] + R[i, j]) / s
    q[1 + k] = (R[k, i] + R[i, k]) / s
    return q


def make_fake_viser():
    viser = types.ModuleType("viser")
    tf = types.ModuleType("viser.transforms")

    class SO3:
        def __init__(self, wxyz):
            self.wxyz = wxyz

        @classmethod
        def from_matrix(cls, R):
            return cls(_mat_to_wxyz(R))

    tf.SO3 = SO3

    class Handle:
        def __init__(self, **kw):
            self.__dict__.update(kw)

    class Scene:
        def __init__(self):
            self.point_clouds = []
            self.frustums = []

        def add_point_cloud(self, name, points, colors, **kw):
            h = Handle(name=name, points=points, colors=colors,
                       visible=True, **kw)
            self.point_clouds.append(h)
            return h

        def add_camera_frustum(self, name, **kw):
            kw.setdefault("visible", True)
            h = Handle(name=name, **kw)
            self.frustums.append(h)
            return h

    class Control(Handle):
        def __init__(self, name, value=None):
            super().__init__(name=name, value=value)
            self.callbacks = []

        def on_update(self, fn):
            self.callbacks.append(fn)
            return fn

        on_click = on_update

        def set(self, value):
            """Test helper: assign + fire callbacks (what real viser does)."""
            self.value = value
            for fn in self.callbacks:
                fn(None)

        def click(self):
            out = None
            for fn in self.callbacks:
                out = fn(None)
            return out

    class Gui:
        def __init__(self):
            self.sliders = []
            self.checkboxes = []
            self.buttons = []

        def _named(self, pool, name):
            return next(c for c in pool if c.name == name)

        def slider(self, name):
            return self._named(self.sliders, name)

        def checkbox(self, name):
            return self._named(self.checkboxes, name)

        def button(self, name):
            return self._named(self.buttons, name)

        def add_slider(self, name, lo, hi, step, value):
            s = Control(name, value)
            self.sliders.append(s)
            return s

        def add_checkbox(self, name, value):
            c = Control(name, value)
            self.checkboxes.append(c)
            return c

        def add_button(self, name):
            b = Control(name)
            self.buttons.append(b)
            return b

    class ViserServer:
        instances = []

        def __init__(self, port=None, **kw):
            self.port = port
            self.scene = Scene()
            self.gui = Gui()
            ViserServer.instances.append(self)

    viser.ViserServer = ViserServer
    viser.transforms = tf
    return viser


def sleepy_server(*args, port=None, **kwargs):
    """A server process target that serves nothing for a minute (the
    session manager's tests start real processes of it)."""
    import time

    time.sleep(60)


def fake_modules() -> dict:
    """{module name: fake module} for ``sys.modules``: gradio, viser and
    viser.transforms."""
    viser = make_fake_viser()
    return {"gradio": make_fake_gradio(), "viser": viser,
            "viser.transforms": viser.transforms}


@pytest.fixture()
def fake_ui(monkeypatch):
    """The fake modules in ``sys.modules`` for one test: (gradio, viser)."""
    mods = fake_modules()
    for name, mod in mods.items():
        monkeypatch.setitem(sys.modules, name, mod)
    return mods["gradio"], mods["viser"]
