"""chip_smoke.py's phases at tiny sizes on the CPU, its refusal to run
without a GPU, and the compile-cache helper every entry point calls."""
import os

import jax
import numpy as np
import pytest

import chip_smoke
from g2o_frontend_tpu.slam.simulator import Simulator3DConfig
from g2o_frontend_tpu.utils import compile_cache

# a 160-pose SE3 world with closures (the default 2,000-pose world's closure
# rules find none at this length)
_SE3_SMALL = Simulator3DConfig(n_poses=160, seed=0, world_size=18.0,
                               closure_min_gap=40, closure_radius=3.5,
                               closure_prob=0.9)


def test_main_refuses_to_run_without_gpu(capsys):
    if jax.default_backend() == "gpu":
        pytest.skip("a GPU is present: main() would run the whole smoke")
    assert chip_smoke.main([]) != 0
    out, err = capsys.readouterr()
    assert '"ok": true' not in out
    assert "needs a GPU" in err


def test_phase_aligner_small():
    res = chip_smoke.phase_aligner("cpu", H=96, W=128)
    assert res["t_err_m"] < 0.01
    assert res["inliers"] > 1000
    # the same device twice: the comparison is exact
    assert res["vs_cpu_dt_m"] == 0.0


@pytest.mark.parametrize("mode", sorted(chip_smoke.ODOMETRY_MODES))
def test_phase_rgbd_odometry_small(tmp_path, mode):
    """4 frames of the generated sequence at scale 4 (120x160). Over 4
    frames the wandering loop moves ~0.5 m per frame, so the bound only
    says the trajectory stays in the scene."""
    res = chip_smoke.phase_rgbd_odometry("cpu", str(tmp_path), frames=4,
                                         scale=4, ate_bound_m=1.0,
                                         modes=(mode,))
    assert np.isfinite(res[mode]["ate_m"])
    assert os.path.isfile(tmp_path / f"traj_{mode}.txt")


@pytest.mark.parametrize("world", ["2d", "se3"])
def test_pose_graph_small(tmp_path, world):
    if world == "2d":
        res = chip_smoke.pose_graph_2d("cpu", n_poses=200, n_landmarks=20,
                                       control_dir=str(tmp_path))
    else:
        res = chip_smoke.pose_graph_se3("cpu", se3_config=_SE3_SMALL,
                                        control_dir=str(tmp_path))
    assert res["chi2"] <= chip_smoke.CHI2_FACTOR * res["control"]
    # the control was computed and cached in the given directory
    (cached,) = os.listdir(tmp_path)
    assert cached.startswith("control_sim")


def test_phase_four_gpus_on_virtual_cpu_mesh(tmp_path):
    res = chip_smoke.phase_four_gpus("cpu", n_devices=4, n_poses=200,
                                     n_landmarks=20, control_dir=str(tmp_path))
    for label in ("edge-sharded LM", "partitioned Schur LM"):
        assert res[label] <= chip_smoke.CHI2_FACTOR * res["control"]
    # each solver's own program splits its edge or block operands over
    # the mesh and communicates
    assert res["sharded split"][0] == 8
    assert res["partitioned split"][0] == 20
    assert res["sharded split"][1]["all-reduce"] > 0
    assert res["halo_mode"] in ("ppermute", "a2a")
    assert res["bytes_per_matvec"] > 0


@pytest.mark.gpu
def test_phase_aligner_on_gpu(gpu_device):
    """The smoke's aligner phase at 640x480 on the card vs its host CPU."""
    res = chip_smoke.phase_aligner(gpu_device.device_kind)
    assert res["t_err_m"] < 0.01


@pytest.fixture
def cache_config():
    """Restore the process's compile-cache setting after the test."""
    saved = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", saved)


def test_compile_cache_uses_checkout_dir_when_unset(monkeypatch, cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable_compile_cache()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(repo, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path


def test_compile_cache_keeps_environment_dir(monkeypatch, tmp_path,
                                             cache_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", None)
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    # no other directory was set in code
    assert jax.config.jax_compilation_cache_dir is None
