"""Key/mouse input frames — behavioral port of key_input.h.

The reference accumulates OS events into a per-frame `Input::Frame`
(key_input.h:157-178) and exposes edge-triggered queries on top of the
post-event down-state (KeyIsDown / KeyWentDown / KeyWentDownOrRepeat /
KeyWentUp, key_input.h:192-249), with the four sided modifier pairs aliased
behind virtual Shift/Control/Alt/Super keys (KeyIsA, key_input.h:189-203).

This module reproduces those semantics for the interactive preview client
(app/preview.py) and anything else that drives the FpsCamera from real
events instead of scripted per-frame args.  `camera_controls` and
`debug_controls` translate a frame into the exact control scheme of the
reference's main loop (camera.h:39-92, main.cpp:72-79).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple


class Key:
    """Key codes (GLFW-compatible values, matching key_input.h:5-170)."""

    INVALID = 0
    SPACE = 32
    # printable keys use their ASCII code: ord('A')..ord('Z'), ord('0')..('9')
    ESCAPE = 256
    ENTER = 257
    TAB = 258
    BACKSPACE = 259
    RIGHT = 262
    LEFT = 263
    DOWN = 264
    UP = 265
    F1 = 290
    LEFT_SHIFT = 340
    LEFT_CONTROL = 341
    LEFT_ALT = 342
    LEFT_SUPER = 343
    RIGHT_SHIFT = 344
    RIGHT_CONTROL = 345
    RIGHT_ALT = 346
    RIGHT_SUPER = 347
    MENU = 348
    # virtual (query-only) modifier aliases — never appear in events or the
    # down-state table (key_input.h:147-151)
    SHIFT = 349
    CONTROL = 350
    ALT = 351
    SUPER = 352
    MOUSE_LEFT = 353
    MOUSE_RIGHT = 354
    MOUSE_MIDDLE = 355
    COUNT = 361


_MOD_SIDES = {
    Key.SHIFT: (Key.LEFT_SHIFT, Key.RIGHT_SHIFT),
    Key.CONTROL: (Key.LEFT_CONTROL, Key.RIGHT_CONTROL),
    Key.ALT: (Key.LEFT_ALT, Key.RIGHT_ALT),
    Key.SUPER: (Key.LEFT_SUPER, Key.RIGHT_SUPER),
}

PRESS = "press"
REPEAT = "repeat"
RELEASE = "release"
TEXT = "text"


def key_is_a(key: int, other: int) -> bool:
    """key_input.h KeyIsA: `key` matches `other`, honoring the virtual
    modifier aliases (a LeftShift event matches a query for SHIFT)."""
    if key == other:
        return True
    sides = _MOD_SIDES.get(other)
    return sides is not None and key in sides


@dataclasses.dataclass
class InputFrame:
    """One frame's events + post-event key state (key_input.h Frame)."""

    events: List[Tuple[str, int]] = dataclasses.field(default_factory=list)
    key_is_down: List[bool] = dataclasses.field(
        default_factory=lambda: [False] * Key.COUNT
    )
    mouse_wheel_input: List[float] = dataclasses.field(
        default_factory=lambda: [0.0, 0.0]
    )
    raw_mouse_input: List[float] = dataclasses.field(
        default_factory=lambda: [0.0, 0.0]
    )

    # -- per-frame event accumulation (ResetFrame / OS_AddEvent) ------------

    def reset(self):
        """Start a new frame: clears events and relative inputs, KEEPS the
        held-key state (key_input.h ResetFrame:181-187)."""
        self.events.clear()
        self.mouse_wheel_input = [0.0, 0.0]
        self.raw_mouse_input = [0.0, 0.0]

    def add_press(self, key: int, repeat: bool = False):
        """A Press event sets the down state; OS repeats arrive as Repeat
        events which do NOT alter it (key_input.h OS_AddEvent)."""
        if key in _MOD_SIDES:
            raise ValueError("virtual modifier keys never generate events")
        if repeat and self.key_is_down[key]:
            self.events.append((REPEAT, key))
        else:
            self.events.append((PRESS, key))
            self.key_is_down[key] = True

    def add_release(self, key: int):
        if key in _MOD_SIDES:
            raise ValueError("virtual modifier keys never generate events")
        self.events.append((RELEASE, key))
        self.key_is_down[key] = False

    def add_text(self, codepoint: int):
        self.events.append((TEXT, codepoint))

    def add_mouse_move(self, dx: float, dy: float):
        self.raw_mouse_input[0] += dx
        self.raw_mouse_input[1] += dy

    def add_mouse_wheel(self, dx: float, dy: float):
        self.mouse_wheel_input[0] += dx
        self.mouse_wheel_input[1] += dy

    # -- queries (key_input.h:205-249) --------------------------------------

    def is_down(self, key: int) -> bool:
        sides = _MOD_SIDES.get(key)
        if sides is not None:
            return self.key_is_down[sides[0]] or self.key_is_down[sides[1]]
        return self.key_is_down[key]

    def went_down(self, key: int) -> bool:
        """True iff the key is down now AND a Press for it happened this
        frame (so a press+release within one frame reports False — matching
        the reference's guard, key_input.h:221)."""
        return self.is_down(key) and any(
            kind == PRESS and key_is_a(k, key) for kind, k in self.events
        )

    def went_down_or_repeat(self, key: int) -> bool:
        return self.is_down(key) and any(
            kind in (PRESS, REPEAT) and key_is_a(k, key)
            for kind, k in self.events
        )

    def went_up(self, key: int) -> bool:
        return not self.is_down(key) and any(
            kind == RELEASE and key_is_a(k, key) for kind, k in self.events
        )

    def text_input(self) -> str:
        return "".join(chr(c) for kind, c in self.events if kind == TEXT)


def camera_controls(frame: InputFrame, mouse_speed_scale: float = 0.5):
    """Translate a frame into FpsCamera.update kwargs per camera.h:39-92:
    WASD forward/right, E/Q up/down, Shift x3 / Ctrl x0.1 speed, and mouse
    look only while the right button is held (camera.h:56-59).  All movement
    is gated behind has_focus = MouseRight-or-Ctrl held (camera.h:51-67).
    The reference passes raw mouse counts through mouse_speed=0.001 while
    FpsCamera.update defaults to 0.002 — mouse_speed_scale compensates."""
    d = frame.is_down
    has_focus = d(Key.MOUSE_RIGHT) or d(Key.CONTROL)
    if has_focus:
        move = (
            (1.0 if d(ord("W")) else 0.0) - (1.0 if d(ord("S")) else 0.0),
            (1.0 if d(ord("D")) else 0.0) - (1.0 if d(ord("A")) else 0.0),
            (1.0 if d(ord("E")) else 0.0) - (1.0 if d(ord("Q")) else 0.0),
        )
    else:
        move = (0.0, 0.0, 0.0)
    if frame.is_down(Key.MOUSE_RIGHT):
        mouse = (frame.raw_mouse_input[0] * mouse_speed_scale,
                 frame.raw_mouse_input[1] * mouse_speed_scale)
    else:
        mouse = (0.0, 0.0)
    return dict(
        move=move,
        mouse=mouse,
        shift=frame.is_down(Key.SHIFT),
        ctrl=frame.is_down(Key.CONTROL),
    )


def debug_controls(frame: InputFrame, sun_angle, visualize_lightgrid):
    """The reference's debug keys (main.cpp:72-79): 9/0 sun pitch, 7/8 sun
    yaw (0.5 deg per held frame), G toggles the lightgrid DDA view.
    Returns (sun_angle, visualize_lightgrid, quit)."""
    sx, sy = float(sun_angle[0]), float(sun_angle[1])
    if frame.is_down(ord("9")):
        sx -= 0.5
    if frame.is_down(ord("0")):
        sx += 0.5
    if frame.is_down(ord("8")):
        sy -= 0.5
    if frame.is_down(ord("7")):
        sy += 0.5
    if frame.went_down(ord("G")):
        visualize_lightgrid = not visualize_lightgrid
    return (sx, sy), visualize_lightgrid, frame.is_down(Key.ESCAPE)
