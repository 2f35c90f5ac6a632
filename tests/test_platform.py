"""Platform plumbing: the pytree dataclass helper, the compile-cache
location, mesh construction and the checkpoint format."""

import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from sift_slam.core import pytree
from sift_slam.parallel import make_mesh
from sift_slam.utils import compile_cache
from sift_slam.utils.checkpoint import restore_checkpoint, save_checkpoint


@pytree.dataclass
class _Pair:
    a: jax.Array
    b: jax.Array
    tag: str = dataclasses.field(default="x", metadata={"static": True})

    @property
    def total(self):
        return self.a + self.b


def test_pytree_dataclass_flatten_unflatten():
    p = _Pair(jnp.ones(3), jnp.arange(3.0), tag="y")
    leaves, treedef = jax.tree.flatten(p)
    assert len(leaves) == 2  # the static field is structure, not a leaf
    q = jax.tree.unflatten(treedef, [2 * x for x in leaves])
    assert isinstance(q, _Pair) and q.tag == "y"
    np.testing.assert_array_equal(np.asarray(q.b), [0.0, 2.0, 4.0])
    with pytest.raises(dataclasses.FrozenInstanceError):
        p.a = jnp.zeros(3)


def test_pytree_dataclass_replace():
    p = _Pair(jnp.ones(2), jnp.zeros(2))
    q = p.replace(b=jnp.full(2, 5.0))
    np.testing.assert_array_equal(np.asarray(q.total), [6.0, 6.0])
    np.testing.assert_array_equal(np.asarray(p.b), [0.0, 0.0])  # unchanged
    assert q.tag == p.tag


def test_pytree_dataclass_through_jit():
    traces = []

    @jax.jit
    def f(p):
        traces.append(p.tag)  # runs only while tracing
        return p.replace(a=p.a * 2)

    out = f(_Pair(jnp.ones(2), jnp.ones(2), tag="u"))
    f(_Pair(jnp.zeros(2), jnp.ones(2), tag="u"))
    f(_Pair(jnp.zeros(2), jnp.ones(2), tag="v"))
    assert isinstance(out, _Pair)
    np.testing.assert_array_equal(np.asarray(out.a), [2.0, 2.0])
    assert traces == ["u", "v"]  # a static field keys the jit cache


@pytest.mark.parametrize("env_set", [True, False], ids=["env", "default"])
def test_compile_cache_location(monkeypatch, tmp_path, env_set):
    saved = jax.config.jax_compilation_cache_dir
    try:
        if env_set:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
            jax.config.update("jax_compilation_cache_dir", "sentinel")
            assert compile_cache.enable_compile_cache() == str(tmp_path)
            # JAX reads the variable itself; the helper sets nothing.
            assert jax.config.jax_compilation_cache_dir == "sentinel"
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            got = compile_cache.enable_compile_cache()
            repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
            assert got == os.path.join(repo, ".cache", "jax")
            assert jax.config.jax_compilation_cache_dir == got
            with open(os.path.join(repo, ".gitignore")) as f:
                assert ".cache/" in f.read().split()
    finally:
        jax.config.update("jax_compilation_cache_dir", saved)


@pytest.mark.parametrize("n", [1, 4])
def test_make_mesh_takes_first_devices(n):
    mesh = make_mesh(n)
    assert list(mesh.devices) == jax.devices()[:n]


def test_make_mesh_raises_when_short():
    with pytest.raises(ValueError, match="requested"):
        make_mesh(len(jax.devices()) + 1)


def test_checkpoint_is_npz_and_json(tmp_path):
    tree = {"r": np.eye(3), "frame": np.asarray(4)}
    path = save_checkpoint(str(tmp_path / "ck"), tree, step=2)
    assert path.endswith(".npz")
    assert sorted(os.listdir(tmp_path / "ck")) == ["step_2.json", "step_2.npz"]
    back = restore_checkpoint(path, tree)
    np.testing.assert_array_equal(np.asarray(back["r"]), np.eye(3))
