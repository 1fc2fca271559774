import os
import time

from garden_tpu.core.ecs import World
from garden_tpu.systems.input import InputSystem
from garden_tpu.systems.misc import AppInfo, AppInfoSystem, FileWatcherSystem, LocaleSystem


def test_input_edge_detection():
    inp = InputSystem()
    inp.push_key_down("w")
    inp.push_cursor(10, 20)
    inp.swap()
    assert inp.is_down("w") and inp.was_pressed("w") and not inp.was_released("w")
    assert inp.cursor == (10, 20)
    # held: no longer 'pressed'
    inp.swap()
    assert inp.is_down("w") and not inp.was_pressed("w")
    inp.push_key_up("w")
    inp.push_cursor(15, 20)
    inp.swap()
    assert not inp.is_down("w") and inp.was_released("w")
    assert inp.cursor_delta == (5, 0)


def test_input_text_and_drops():
    inp = InputSystem()
    inp.push_text("he")
    inp.push_text("llo")
    inp.push_file_drop("/tmp/model.obj")
    inp.swap()
    assert inp.text == "hello"
    assert inp.dropped_files == ["/tmp/model.obj"]
    inp.swap()
    assert inp.text == "" and inp.dropped_files == []


def test_locale():
    loc = LocaleSystem("en")
    loc.load_locale("en", {"menu.start": "Start"})
    loc.load_locale("de", {"menu.start": "Starten"})
    assert loc.get("menu.start") == "Start"
    loc.set_locale("de")
    assert loc.get("menu.start") == "Starten"
    assert loc.get("missing.key") == "missing.key"
    assert loc.get("missing.key", "fallback") == "fallback"


def test_file_watcher(tmp_path):
    p = tmp_path / "shader.gsl"
    p.write_text("v1")
    fw = FileWatcherSystem()
    fw.watch(str(p))
    changes = []
    fw.on_change(changes.append)
    assert fw.poll() == []
    time.sleep(0.01)
    os.utime(str(p), (time.time() + 1, time.time() + 1))
    assert fw.poll() == [str(p)]
    assert changes == [str(p)]


def test_app_info(tmp_path):
    info = AppInfo(name="demo", cache_path=str(tmp_path / "cache"))
    s = AppInfoSystem(info)
    path = s.cache_path("pipelines.bin")
    assert os.path.isdir(str(tmp_path / "cache"))
    assert path.endswith("pipelines.bin")


def test_quality_presets():
    from garden_tpu.core.config import render_quality
    potato = render_quality("potato")
    ultra = render_quality("ultra", width=640)
    assert not potato.use_shadows and potato.render_scale == 0.5
    assert ultra.use_clouds and ultra.shadow.map_size == 2048
    assert ultra.width == 640


def test_contact_events():
    import numpy as np
    from garden_tpu.systems.events import ContactEvents
    ev = ContactEvents()
    t1 = np.full((4, 3), -1); t1[0, 0] = 1; t1[1, 0] = 0
    out = ev.process(t1)
    assert out["entered"] == [(0, 1)] and out["exited"] == []
    out = ev.process(t1)
    assert out["stayed"] == [(0, 1)] and out["entered"] == []
    t2 = np.full((4, 3), -1)
    out = ev.process(t2)
    assert out["exited"] == [(0, 1)]


def test_fpv_controller():
    from garden_tpu.systems.controller import FpvController
    from garden_tpu.systems.input import InputSystem
    inp = InputSystem()
    fpv = FpvController(position=(0, 0, 0), yaw=0.0)
    inp.push_key_down("w")
    inp.swap()
    fpv.process(inp, 1.0)
    # default forward is -z
    assert fpv.position[2] < -5.0
    inp.push_cursor(100, 0); inp.swap(); inp.push_cursor(200, 0); inp.swap()
    fpv.process(inp, 0.0)
    assert fpv.yaw != 0.0


def test_encoding_and_file_utils(tmp_path):
    """base64/utf/file helpers (base64.cpp, utf.cpp, file.cpp analogs)."""
    from garden_tpu.core import utils

    data = bytes(range(256))
    assert utils.base64_decode(utils.base64_encode(data)) == data
    assert utils.base64_decode(
        utils.base64_encode(data, url_safe=True), url_safe=True) == data
    # unpadded input tolerated
    assert utils.base64_decode("aGk") == b"hi"

    s = "héllo \U0001F600 wörld"
    assert utils.utf16_to_utf8(utils.utf8_to_utf16(s)) == s
    assert utils.utf32_to_utf8(utils.utf8_to_utf32(s)) == s
    assert utils.codepoint_count("a\U0001F600") == 2

    p = tmp_path / "nested" / "f.txt"
    utils.write_text(p, s)
    assert utils.read_text(p) == s
    utils.write_bytes(tmp_path / "b.bin", data)
    assert utils.read_bytes(tmp_path / "b.bin") == data


def test_debug_view_observability(tmp_path):
    """Editor-parity observability: contact sheet, cascade
    atlas view, draw/contact counters, and the one-call debug sheet."""
    import numpy as np

    from garden_tpu.utils import debug_view as dv

    h, w = 32, 48
    rng = np.random.default_rng(0)
    tri_id = rng.integers(-1, 5, (h, w))
    out = {
        "image": (rng.uniform(0, 255, (h, w, 3))).astype(np.uint8),
        "depth": rng.uniform(0, 1, (h, w)).astype(np.float32),
        "tri_id": tri_id,
        "gbuffer": {
            "normal": rng.uniform(-1, 1, (h, w, 3)).astype(np.float32),
            "base_color": rng.uniform(0, 1, (h, w, 3)).astype(np.float32),
            "roughness": rng.uniform(0, 1, (h, w)).astype(np.float32),
            "metallic": rng.uniform(0, 1, (h, w)).astype(np.float32),
            "visible": tri_id >= 0,
        },
        "shadow": rng.uniform(0, 1, (h, w, 3)).astype(np.float32),
        "ao": rng.uniform(0, 1, (h, w)).astype(np.float32),
        "velocity": None, "disocclusion": None, "trans_depth": None,
    }
    state = {
        "bodies": {
            "pos": rng.uniform(-5, 5, (16, 3)).astype(np.float32),
            "linvel": rng.uniform(-1, 1, (16, 3)).astype(np.float32),
            "has": np.ones(16, bool),
        },
        "contacts": {"valid": rng.uniform(0, 1, (16, 4)) > 0.7},
    }
    report = dv.dump_debug_sheet(out, state, None, str(tmp_path))
    assert (tmp_path / "gbuffer_sheet.png").exists()
    assert (tmp_path / "physics_top.png").exists()
    assert (tmp_path / "stats.txt").exists()
    assert report["render"]["pixels"] == h * w
    assert report["render"]["pixels_covered"] == int((tri_id >= 0).sum())
    assert report["physics"]["bodies_alive"] == 16
    assert report["physics"]["contacts"] == int(
        state["contacts"]["valid"].sum())

    dv.dump_cascade_atlas(
        rng.uniform(0, 1, (64, 128)).astype(np.float32),
        str(tmp_path / "atlas.png"))
    assert (tmp_path / "atlas.png").exists()
