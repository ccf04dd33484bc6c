"""Kernel B's plain path (bias + All-ReLU) and the activations of the port,
against the JAX reference on the CPU, and the kernel plumbing (build, input
checks). The kernels themselves are held against their plain versions on
the card in ``test_torch_gpu.py``.

The Pallas ``bias_all_relu`` runs in interpret mode, as the reference's own
tests run it. f32 add, compare and multiply round the same way in both
packages, so kernel B's plain version is held bit-equal.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; the card's machine has none
import jax.numpy as jnp  # noqa: E402

from repro.core import all_relu as jar
from repro.kernels import ref as jref
from repro.kernels.all_relu_fused import bias_all_relu as pallas_bias_all_relu
from repro_torch.core import all_relu as tar
from repro_torch.kernels import all_relu_fused, build
from repro_torch.kernels import ref as tref

jax.config.update("jax_platform_name", "cpu")


def _xb(seed, rows, n):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, n)).astype(np.float32)
    x[0, : min(n, 3)] = [0.0, -0.0, 1e-30][: min(n, 3)]  # zeros and a denormal-range value
    return x, rng.standard_normal((n,)).astype(np.float32)


@pytest.mark.parametrize("shape", [(6, 32), (300, 40)])  # 300 rows: not a multiple of 256
@pytest.mark.parametrize("layer_index", [1, 2, 3, 4])
@pytest.mark.parametrize("alpha", [0.05, 0.6, 0.75])
def test_bias_all_relu_matches_pallas(shape, layer_index, alpha):
    x, b = _xb(layer_index, *shape)
    want = pallas_bias_all_relu(
        jnp.asarray(x), jnp.asarray(b), alpha=alpha, layer_index=layer_index, interpret=True
    )
    got = all_relu_fused.bias_all_relu(
        torch.as_tensor(x), torch.as_tensor(b), alpha=alpha, layer_index=layer_index
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_bias_all_relu_leading_dims_and_ref():
    x, b = _xb(9, 12, 8)
    x3 = torch.as_tensor(x).reshape(3, 4, 8)
    got = all_relu_fused.bias_all_relu(x3, torch.as_tensor(b), alpha=0.6, layer_index=2)
    assert got.shape == (3, 4, 8)
    want = tref.all_relu_ref(x3 + torch.as_tensor(b), 0.6, 2)
    assert torch.equal(got, want)
    np.testing.assert_array_equal(
        want.numpy(), np.asarray(jref.all_relu_ref(jnp.asarray(x3.numpy() + b), 0.6, 2))
    )


@pytest.mark.parametrize("name", ["all_relu", "relu", "leaky_relu", "silu", "gelu", "gelu_tanh"])
@pytest.mark.parametrize("layer_index", [1, 2])
def test_activations_match_reference(name, layer_index):
    x, _ = _xb(10, 7, 16)
    want = jar.activation_fn(name, alpha=0.6)(jnp.asarray(x), layer_index)
    got = tar.activation_fn(name, alpha=0.6)(torch.as_tensor(x), layer_index)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        tar.activation_fn("nope")


def test_srelu_matches_reference():
    x, _ = _xb(11, 5, 6)
    params = np.random.default_rng(12).standard_normal((4, 6)).astype(np.float32)
    want = jar.srelu(jnp.asarray(x), *(jnp.asarray(p) for p in params))
    got = tar.srelu(torch.as_tensor(x), *(torch.as_tensor(p) for p in params))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# kernel plumbing that runs anywhere
# ---------------------------------------------------------------------------


def _lazy(shape):
    """A tensor on a device that is neither the card, the CPU, ``meta`` nor
    fake: the TorchScript lazy backend, which needs no hardware."""
    import torch._lazy.ts_backend

    try:
        torch._lazy.ts_backend.init()
    except RuntimeError as e:  # it registers once a process
        if "multiple backend fallbacks" not in str(e):
            raise
    return torch.empty(shape, device="lazy")


def test_bias_all_relu_rejects_other_devices():
    """A wrapper raises for a device it does not take. A ``meta`` tensor
    takes the plain version (the dry run's route) and launches nothing."""
    with pytest.raises(ValueError, match="cuda or cpu"):
        all_relu_fused.bias_all_relu(_lazy((2, 4)), _lazy((4,)), alpha=0.5, layer_index=1)
    before = all_relu_fused.bias_all_relu.launches
    y = all_relu_fused.bias_all_relu(
        torch.empty((2, 4), device="meta"), torch.empty((4,), device="meta"),
        alpha=0.5, layer_index=1,
    )
    assert y.device.type == "meta" and y.shape == (2, 4)
    assert all_relu_fused.bias_all_relu.launches == before


def test_check_tensor_rejects_what_kernels_do_not_take():
    cpu = torch.device("cpu")
    x = torch.zeros((4, 6))
    build.check_tensor(x, "x", dtype=torch.float32, shape=(4, 6), device=cpu)
    with pytest.raises(ValueError, match="dtype"):
        build.check_tensor(x.double(), "x", dtype=torch.float32, shape=(4, 6), device=cpu)
    with pytest.raises(ValueError, match="shape"):
        build.check_tensor(x, "x", dtype=torch.float32, shape=(6, 4), device=cpu)
    with pytest.raises(ValueError, match="contiguous"):
        build.check_tensor(x.T, "x", dtype=torch.float32, shape=(6, 4), device=cpu)
    with pytest.raises(ValueError, match="meta"):
        build.check_tensor(x.to("meta"), "x", dtype=torch.float32, shape=(4, 6), device=cpu)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build()


def test_library_path_tracks_the_source():
    for source in build.KERNEL_SOURCES:
        path = build.library_path(source)
        assert path.parent == build.BUILD_DIR
        assert path.name.startswith(f"lib{source}-") and path.suffix == ".so"
        assert (build.CSRC / f"{source}.cu").exists()


def test_launch_errors_raise():
    build.check_launch(0, "kernel")
    with pytest.raises(RuntimeError, match="kernel failed"):
        build.check_launch(1, "kernel")
