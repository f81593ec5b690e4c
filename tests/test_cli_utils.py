"""CLI smoke tests + observability utilities (SURVEY.md §5.1/§5.5)."""

import json
import os

import numpy as np
import pytest

from halogen_tpu.utils.metrics import RaysMeter, RenderStats


def test_rays_meter_window():
    now = [0.0]
    meter = RaysMeter(window_s=1.0, clock=lambda: now[0])
    for k in range(10):
        now[0] = k * 0.1
        meter.add(1_000_000)
    # 10 Mrays over ~0.9s window
    assert 8.0 < meter.mrays_per_sec < 13.0
    now[0] = 5.0  # everything aged out
    assert meter.mrays_per_sec == 0.0


def test_render_stats_mrays():
    st = RenderStats(frame=1, width=100, height=100, spp=4, wall_s=0.004)
    assert st.rays == 40_000
    np.testing.assert_allclose(st.mrays_per_sec, 10.0)


@pytest.mark.slow
def test_cli_render_and_bench(tmp_path, capsys):
    from halogen_tpu.cli.main import main

    out = os.path.join(tmp_path, "r.png")
    rc = main(["render", "--scene", "cornell", "--width", "16", "--spp", "1",
               "--bounces", "1", "--frames", "1", "--chunk", "256",
               "--out", out])
    assert rc == 0
    assert os.path.exists(out) or os.path.exists(out + ".npy")

    rc = main(["bench", "--scene", "cornell", "--width", "16", "--spp", "1",
               "--bounces", "1", "--frames", "1", "--chunk", "256",
               "--out", out])
    assert rc == 0
    line = [l for l in capsys.readouterr().out.splitlines()
            if l.startswith("{")][-1]
    rec = json.loads(line)
    assert set(rec) == {"metric", "value", "unit", "device"}
    assert rec["device"]["platform"] == "cpu"
    assert rec["value"] > 0


def test_cli_debug_sobol(tmp_path):
    from halogen_tpu.cli.main import main

    out = os.path.join(tmp_path, "s.png")
    rc = main(["debug-sobol", "--width", "32", "--count", "5000",
               "--out", out])
    assert rc == 0
    assert os.path.exists(out) or os.path.exists(out + ".npy")


def test_cli_checkpoint_resume(tmp_path):
    from halogen_tpu.cli.main import main

    out = os.path.join(tmp_path, "r.png")
    ck = os.path.join(tmp_path, "state.npz")
    for _ in range(2):
        rc = main(["render", "--scene", "cornell", "--width", "16",
                   "--spp", "1", "--bounces", "1", "--frames", "2",
                   "--chunk", "256", "--out", out, "--checkpoint", ck])
        assert rc == 0
    data = np.load(ck)
    assert int(data["frame_count"]) >= 3  # resumed past the first run
