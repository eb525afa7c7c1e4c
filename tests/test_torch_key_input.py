"""The port's app/key_input.py: input-frame semantics vs key_input.h:181-249
(event accumulation, edge-triggered queries, modifier aliasing) and the
main-loop control translation (camera.h:39-92, main.cpp:72-79).  The module
is a copy of the JAX package's (stdlib only), so the same cases run on it
and the two sources are held equal."""

from pathlib import Path

from vulkan_pbr_renderer_tpu_torch.app.key_input import (
    InputFrame, Key, camera_controls, debug_controls,
)


def test_copy_equals_jax_source():
    root = Path(__file__).resolve().parents[1]
    assert ((root / "vulkan_pbr_renderer_tpu_torch/app/key_input.py").read_text()
            == (root / "vulkan_pbr_renderer_tpu/app/key_input.py").read_text())


def test_went_down_edge_semantics():
    f = InputFrame()
    f.add_press(ord("W"))
    assert f.is_down(ord("W")) and f.went_down(ord("W"))
    f.reset()  # next frame: still held, no new event
    assert f.is_down(ord("W")) and not f.went_down(ord("W"))
    f.add_release(ord("W"))
    assert not f.is_down(ord("W")) and f.went_up(ord("W"))
    f.reset()
    assert not f.went_up(ord("W"))


def test_press_release_same_frame_reports_neither_edge():
    # WentDown is guarded on IsDown (key_input.h:221) and WentUp on !IsDown:
    # a press+release inside one frame reports went_up only
    f = InputFrame()
    f.add_press(ord("G"))
    f.add_release(ord("G"))
    assert not f.went_down(ord("G"))
    assert f.went_up(ord("G"))


def test_repeat_events():
    f = InputFrame()
    f.add_press(ord("A"))
    f.reset()
    f.add_press(ord("A"), repeat=True)   # OS auto-repeat
    assert not f.went_down(ord("A"))
    assert f.went_down_or_repeat(ord("A"))


def test_modifier_aliasing():
    f = InputFrame()
    f.add_press(Key.RIGHT_SHIFT)
    assert f.is_down(Key.SHIFT) and f.went_down(Key.SHIFT)
    assert not f.is_down(Key.LEFT_SHIFT)
    f.reset()
    f.add_release(Key.RIGHT_SHIFT)
    assert f.went_up(Key.SHIFT)


def test_mouse_accumulation_resets_per_frame():
    f = InputFrame()
    f.add_mouse_move(3.0, -2.0)
    f.add_mouse_move(1.0, 1.0)
    assert f.raw_mouse_input == [4.0, -1.0]
    f.reset()
    assert f.raw_mouse_input == [0.0, 0.0]


def test_camera_controls_mapping():
    f = InputFrame()
    f.add_press(ord("W"))
    f.add_press(ord("D"))
    f.add_press(Key.LEFT_SHIFT)
    f.add_mouse_move(10.0, 4.0)
    kw = camera_controls(f)
    # movement is gated behind has_focus = MouseRight-or-Ctrl (camera.h:51-67)
    assert kw["move"] == (0.0, 0.0, 0.0)
    assert kw["shift"] and not kw["ctrl"]
    # mouse look requires the right button held (camera.h:56)
    assert kw["mouse"] == (0.0, 0.0)
    f.add_press(Key.MOUSE_RIGHT)
    kw = camera_controls(f, mouse_speed_scale=0.5)
    assert kw["mouse"] == (5.0, 2.0)
    assert kw["move"] == (1.0, 1.0, 0.0)


def test_debug_controls():
    f = InputFrame()
    f.add_press(ord("9"))
    f.add_press(ord("G"))
    sun, viz, quit_ = debug_controls(f, (35.0, 80.0), False)
    assert sun == (34.5, 80.0) and viz and not quit_
    f.reset()  # G still held but no new press: no re-toggle
    sun, viz, quit_ = debug_controls(f, sun, viz)
    assert viz
    f.add_press(Key.ESCAPE)
    _, _, quit_ = debug_controls(f, sun, viz)
    assert quit_
