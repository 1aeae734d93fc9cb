"""`chip_smoke.py` on the CPU: it refuses to run without a GPU, and each
phase runs end to end at a tiny size (the device passed in by the test),
so a chip run does not find its first fault in control flow."""

import dataclasses

import jax
import pytest

import chip_smoke

TINY = chip_smoke.Sizes(
    frame_px=32, frame_faces=600, frame_iters=1, api_px=32, cli_frames=1,
    bvh_px=32, grad_px=32, f16_faces=300, armadillo_faces=500,
    train_steps=2, ref_px=32, ref_faces=400, bounce_hw=(24, 40),
    bounce_scale=2000, bounce_iters=1, bounce_samples=256, fill_px=16)


@pytest.mark.parametrize("argv", [[], ["--four-cards"]])
def test_main_refuses_cpu(argv, capsys):
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main(argv)
    assert "no GPU" in str(exc.value.code)
    assert '"ok"' not in capsys.readouterr().out


def test_sizes_default_to_full_scale():
    full = chip_smoke.Sizes()
    assert (full.frame_px, full.frame_faces) == (512, 69630)
    assert full.grad_px == 1024 and full.f16_faces + full.armadillo_faces \
        == 350000
    assert full.bounce_hw == (1080, 1920) and full.bounce_scale == 1
    assert full.bounce_samples >= 16384
    assert dataclasses.replace(full, frame_px=32) != full


def test_phase_frame():
    res = chip_smoke.phase_frame(jax.devices()[0], TINY)
    assert res["face_match"] >= chip_smoke.MATCH_SHARE
    assert 0 < res["hit_share"] < 1 and res["ms_per_frame"] > 0


def test_phase_api(tmp_path):
    res = chip_smoke.phase_api(jax.devices()[0], TINY, str(tmp_path))
    assert 0 < res["trace_scene_hit_share"] < 1
    assert (tmp_path / "frame_0000.png").stat().st_size > 0


def test_phase_grad():
    res = chip_smoke.phase_grad(jax.devices()[0], TINY,
                                cpu=jax.devices("cpu")[1])
    assert len(res["train_losses"]) == 2 + TINY.train_steps
    assert res["ref_grad_rel_pos"] <= 1e-3


def test_phase_bounce():
    res = chip_smoke.phase_bounce(jax.devices()[0], TINY)
    assert res["bounce_changed_px_share"] > 0
    assert res["oracle_samples"] == 256


def test_phase_fill():
    res = chip_smoke.phase_fill(jax.devices()[0], TINY)
    assert res["gradient_max_channel_diff"] <= 1


def test_phase_four_cards():
    """The four-card path on four of the eight virtual CPU devices."""
    res = chip_smoke.phase_four_cards(jax.devices()[:4], TINY)
    assert res["devices"] == 4 and res["ring_face_ids"] == "equal"


def test_smoke_failure_raises_even_under_optimization():
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.require(False, "boom")
