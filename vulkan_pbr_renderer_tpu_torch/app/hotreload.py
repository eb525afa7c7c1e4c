"""Shader-hot-reload equivalent: watch shading modules, re-import them
(counterpart of vulkan_pbr_renderer_tpu/app/hotreload.py).

The reference polls one GLSL file's mtime per frame and rebuilds that pass's
pipeline on change (HotreloadShaders, render.cpp:62-627; error box + retry at
render.cpp:18-24).  Our "shaders" are Python modules under shade/, so the
live-editing workflow becomes: watch mtimes -> importlib.reload.  PyTorch runs
eagerly, so there is no trace to drop: the next frame calls the new code,
because app/renderer.py and the shade modules reach each other's functions
through the module objects (`bloom.resize_linear`), never bound by name.
Errors are caught and reported; the previous working code keeps rendering (no
blocking message box needed).
"""

from __future__ import annotations

import importlib
import os
import sys
import traceback

WATCHED_PREFIX = "vulkan_pbr_renderer_tpu_torch.shade"


class ShaderWatcher:
    def __init__(self, prefix=WATCHED_PREFIX):
        self.prefix = prefix
        self.mtimes = {}
        self._scan(initial=True)

    def _modules(self):
        return [m for name, m in sys.modules.items()
                if name.startswith(self.prefix) and getattr(m, "__file__", None)]

    def _scan(self, initial=False):
        changed = []
        for m in self._modules():
            try:
                t = os.path.getmtime(m.__file__)
            except OSError:
                continue
            old = self.mtimes.get(m.__name__)
            self.mtimes[m.__name__] = t
            if not initial and old is not None and t > old:
                changed.append(m)
        return changed

    def poll(self, renderer=None):
        """Call once per frame (like render.cpp:66-83: one stat per frame).

        Returns True if modules were reloaded (the caller's next render runs
        the new code).  On reload errors the old code keeps running and the
        result is False.  Temporal state (renderer.state) survives.
        """
        changed = self._scan()
        if not changed:
            return False
        ok = True
        for m in changed:
            try:
                importlib.reload(m)
            except Exception:
                traceback.print_exc()
                ok = False
        return ok
