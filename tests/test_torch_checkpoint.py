"""The port's checkpoint format (``repro_torch.checkpoint.io`` over its
own msgpack codec, ``repro_torch.checkpoint._msgpack``) against the JAX
package's ``repro.checkpoint.io``: the six tests of
``tests/test_checkpoint.py`` mirrored on the port (round trip, shape
and key errors, the flat load, truncation, an interrupted save); a file
or bytes written by either package loads in the other with equal keys,
bitwise-equal arrays (bf16 included) and equal metadata, for the paper
LSTM and the reduced Qwen1.5-4B and Mamba2-370M trees in bf16; and the
codec byte-equal to ``msgpack.packb(use_bin_type=True)`` and equal to
``msgpack.unpackb`` on drawn values and on the registry's metadata."""

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from repro.checkpoint import io as jio
from repro.configs import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.models import rnn as jrnn
from repro.models.transformer import init_lm as jinit_lm
from repro_torch.checkpoint import (CheckpointCorruptError, load_checkpoint,
                                    save_checkpoint)
from repro_torch.checkpoint import _msgpack
from repro_torch.checkpoint import io as tio
from repro_torch.checkpoint.convert import (params_from_numpy,
                                            zoo_params_from_numpy)
from repro_torch.configs import get_config
from repro_torch.configs.base import reduced
from repro_torch.tree import tree_flatten_with_path, tree_leaves


def test_roundtrip(tmp_path):
    tree = {"layers": {"w": torch.arange(6.0).reshape(2, 3),
                       "b": torch.ones((3,), dtype=torch.bfloat16)},
            "step": torch.tensor(7, dtype=torch.int32)}
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, tree, metadata={"round": 3, "note": "hi"})
    like = {"layers": {"w": np.zeros((2, 3), np.float32),
                       "b": torch.zeros((3,), dtype=torch.bfloat16)},
            "step": np.zeros((), np.int32)}
    loaded, meta = load_checkpoint(path, like=like)
    assert meta == {"round": 3, "note": "hi"}
    assert torch.equal(loaded["layers"]["w"], tree["layers"]["w"])
    assert loaded["layers"]["b"].dtype == torch.bfloat16
    assert torch.equal(loaded["layers"]["b"], tree["layers"]["b"])
    assert loaded["step"] == 7 and loaded["step"].dtype == torch.int32


def test_shape_mismatch_raises(tmp_path):
    path = str(tmp_path / "c.npz")
    save_checkpoint(path, {"w": torch.zeros((2, 2))})
    with pytest.raises(ValueError):
        load_checkpoint(path, like={"w": np.zeros((3, 3))})


def test_missing_key_raises(tmp_path):
    path = str(tmp_path / "c.npz")
    save_checkpoint(path, {"w": torch.zeros((2,))})
    with pytest.raises(KeyError):
        load_checkpoint(path, like={"w2": np.zeros((2,))})


def test_flat_load(tmp_path):
    path = str(tmp_path / "c.npz")
    save_checkpoint(path, {"a": {"b": torch.ones((2,))}})
    flat, meta = load_checkpoint(path)
    assert "a/b" in flat and meta is None
    assert isinstance(flat["a/b"], np.ndarray)


def test_truncated_checkpoint_raises_clean_error(tmp_path):
    """A torn write (truncation, the common power-cut shape) surfaces as
    CheckpointCorruptError naming the file, from a file and from
    bytes."""
    path = str(tmp_path / "c.npz")
    save_checkpoint(path, {"w": torch.arange(64.0)}, metadata={"round": 1})
    data = open(path, "rb").read()
    for cut in (len(data) // 2, 10, 0):
        with open(path, "wb") as f:
            f.write(data[:cut])
        with pytest.raises(CheckpointCorruptError, match="c.npz"):
            load_checkpoint(path)
        with pytest.raises(CheckpointCorruptError):
            tio.load_checkpoint_bytes(data[:cut])


def test_interrupted_save_never_tears_the_checkpoint(tmp_path, monkeypatch):
    """A crash mid-save (os.replace never runs) leaves the previous
    checkpoint intact and loadable."""
    path = str(tmp_path / "c.npz")
    save_checkpoint(path, {"w": torch.zeros((4,))}, metadata={"round": 1})

    def _boom(*a, **k):
        raise OSError("simulated crash before rename")

    monkeypatch.setattr(tio.os, "replace", _boom)
    with pytest.raises(OSError):
        save_checkpoint(path, {"w": torch.ones((4,))}, metadata={"round": 2})
    monkeypatch.undo()
    loaded, meta = load_checkpoint(path, like={"w": np.zeros((4,),
                                                              np.float32)})
    assert meta == {"round": 1}          # the old checkpoint, whole
    assert torch.equal(loaded["w"], torch.zeros(4))


# -- cross-loading between the packages -----------------------------------

RNN_J = jrnn.RNNConfig()


def _jax_trees():
    """(name, the JAX package's params, the same weights in the port):
    the paper LSTM (fp32) and the reduced Qwen1.5-4B and Mamba2-370M in
    bf16 (their dt_bias and A_log fp32)."""
    jp = jrnn.init_rnn(jax.random.PRNGKey(0), RNN_J)
    out = [("paper-lstm", jp, params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp), device="cpu"))]
    for arch in ("qwen1.5-4b", "mamba2-370m"):
        jcfg = jreduced(jget_config(arch), dtype="bfloat16")
        jparams = jinit_lm(jcfg, jax.random.PRNGKey(1))
        cfg = reduced(get_config(arch), dtype="bfloat16")
        tparams = zoo_params_from_numpy(
            cfg, jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
        out.append((arch, jparams, tparams))
    return out


TREES = _jax_trees()
LEAVES = {"paper-lstm": 14, "qwen1.5-4b": 15, "mamba2-370m": 12}
META = {"kind": "zoo", "tail": {"xi": 1.25, "scale": 0.5,
                                "tail_at_xi": 0.05},
        "gamma": 5.0, "version": 3, "eps": [0.01, 0.02], "reduced": True,
        "arch": "x", "none": None, "neg": -70000, "big": 2 ** 40}


def _bits(a) -> np.ndarray:
    """The array's bytes as unsigned integers of its width (bf16 from
    either package, as ml_dtypes arrays or torch tensors)."""
    if isinstance(a, torch.Tensor):
        a = a.view({2: torch.int16, 1: torch.uint8}[a.element_size()]) \
            if a.dtype in (torch.bfloat16, torch.float8_e4m3fn,
                           torch.float8_e5m2) else a
        a = a.numpy()
    a = np.asarray(a)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32,
                   8: np.uint64}[a.dtype.itemsize])


def _dtype_name(a) -> str:
    if isinstance(a, torch.Tensor):
        return str(a.dtype).removeprefix("torch.")
    return np.asarray(a).dtype.name


def _assert_flat_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert _dtype_name(got[k]) == _dtype_name(want[k]), k
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]),
                                      err_msg=k)


@pytest.mark.parametrize("name,jparams,tparams", TREES,
                         ids=[t[0] for t in TREES])
def test_jax_file_loads_in_port_and_back(tmp_path, name, jparams, tparams):
    """repro.checkpoint.io.save_checkpoint -> the port's load, then the
    port's save -> the JAX package's load: equal keys, bitwise arrays
    and dtypes (bf16 as bf16), equal metadata, both ways."""
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jio.save_checkpoint(jpath, jparams, metadata=META)
    jflat, jmeta = jio.load_checkpoint(jpath)
    assert len(jflat) == LEAVES[name]
    tflat, tmeta = tio.load_checkpoint(jpath)
    assert tmeta == jmeta == META
    _assert_flat_equal(tflat, jflat)
    # the port's tree of the same weights names its leaves the same way
    assert sorted("/".join(map(str, p)) for p, _ in
                  tree_flatten_with_path(tparams)) == sorted(jflat)
    # assembled into the port's tree: the port's own weights, bitwise
    got, _ = tio.load_checkpoint(jpath, like=tparams)
    for a, b in zip(tree_leaves(got), tree_leaves(tparams)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    tio.save_checkpoint(tpath, tparams, metadata=META)
    back, bmeta = jio.load_checkpoint(tpath)
    assert bmeta == META
    _assert_flat_equal(back, jflat)
    # and the JAX package assembles the port's file into its own tree
    like = jax.tree_util.tree_map(np.asarray, jparams)
    jtree, _ = jio.load_checkpoint(tpath, like=like)
    for a, b in zip(jax.tree_util.tree_leaves(jtree),
                    jax.tree_util.tree_leaves(like)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(_bits(a), _bits(b))


@pytest.mark.parametrize("name,jparams,tparams", TREES,
                         ids=[t[0] for t in TREES])
def test_checkpoint_bytes_cross_load(name, jparams, tparams):
    """The same through dump_checkpoint_bytes / load_checkpoint_bytes."""
    jdata = jio.dump_checkpoint_bytes(jparams, metadata=META)
    jflat, jmeta = jio.load_checkpoint_bytes(jdata)
    tflat, tmeta = tio.load_checkpoint_bytes(jdata)
    assert tmeta == jmeta == META
    _assert_flat_equal(tflat, jflat)
    back, bmeta = jio.load_checkpoint_bytes(
        tio.dump_checkpoint_bytes(tparams, metadata=META))
    assert bmeta == META
    _assert_flat_equal(back, jflat)


def test_assemble_casts_to_like_and_places_on_device():
    """``assemble`` casts each leaf to the dtype of ``like`` (so a bf16
    model's fp32 dt_bias and A_log stay fp32) and needs a device for a
    like on the meta device."""
    from repro_torch.models.transformer import init_lm

    cfg = reduced(get_config("mamba2-370m"), dtype="bfloat16")
    _, jparams, tparams = TREES[2]
    flat, _ = tio.load_checkpoint_bytes(jio.dump_checkpoint_bytes(jparams))
    like = init_lm(cfg, None)
    with pytest.raises(ValueError, match="meta"):
        tio.assemble(flat, like)
    got = tio.assemble(flat, like, device="cpu")
    dtypes = {"/".join(map(str, p)): a.dtype
              for p, a in tree_flatten_with_path(got)}
    assert {k for k, d in dtypes.items() if d == torch.float32} == \
        {"layers/ssm/dt_bias", "layers/ssm/A_log"}
    want = dict(tree_flatten_with_path(tparams))
    for path, a in tree_flatten_with_path(got):
        assert a.device.type == "cpu" and torch.equal(a, want[path]), path


# -- the msgpack codec ----------------------------------------------------

_INT_EDGES = [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
              2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769,
              -2 ** 31, -2 ** 31 - 1, -2 ** 63]
_scalars = (st.none() | st.booleans()
            | st.integers(min_value=-2 ** 63, max_value=2 ** 64 - 1)
            | st.sampled_from(_INT_EDGES)
            | st.floats(allow_nan=False)
            | st.text(max_size=300) | st.binary(max_size=300))
_values = st.recursive(
    _scalars,
    lambda inner: (st.lists(inner, max_size=20)
                   | st.tuples(inner, inner)
                   | st.dictionaries(st.text(max_size=40), inner,
                                     max_size=20)),
    max_leaves=60)


def _same(a, b) -> bool:
    """Equal, with float bits compared (so -0.0 != 0.0) and tuples read
    back as lists, as msgpack gives them."""
    if isinstance(b, float):
        return isinstance(a, float) and np.float64(a).tobytes() == \
            np.float64(b).tobytes()
    if isinstance(b, (list, tuple)):
        return isinstance(a, list) and len(a) == len(b) and all(
            _same(x, y) for x, y in zip(a, b))
    if isinstance(b, dict):
        return isinstance(a, dict) and list(a) == list(b) and all(
            _same(a[k], b[k]) for k in b)
    return type(a) is type(b) and a == b


# The property holds at any speed: its 100 examples carry no deadline and
# skip the health checks that only time the strategy (its recursive
# values take long to draw on a busy host running many test workers).
@settings(max_examples=100, deadline=None,
          suppress_health_check=[HealthCheck.too_slow,
                                 HealthCheck.data_too_large,
                                 HealthCheck.filter_too_much])
@given(_values)
def test_msgpack_codec_matches_msgpack(value):
    want = msgpack.packb(value, use_bin_type=True)
    assert _msgpack.packb(value) == want
    assert _same(_msgpack.unpackb(want), msgpack.unpackb(want, raw=False))


@pytest.mark.parametrize("n", [0, 15, 16, 31, 32, 255, 256, 65535, 65536])
def test_msgpack_codec_headers_at_every_length(n):
    """The fix, 8-, 16- and 32-bit headers of str, bin, array and map at
    their boundaries."""
    for value in ("x" * n, b"y" * n, list(range(n)),
                  {str(i): i for i in range(n)}):
        want = msgpack.packb(value, use_bin_type=True)
        assert _msgpack.packb(value) == want
        assert _msgpack.unpackb(want) == msgpack.unpackb(want, raw=False)


def test_msgpack_codec_decodes_float32_and_refuses_other_types():
    for x in (1.5, -0.25, 3.0e38):
        data = msgpack.packb(x, use_single_float=True)
        assert data[0] == 0xCA
        assert _msgpack.unpackb(data) == msgpack.unpackb(data)
    ext = msgpack.packb(msgpack.ExtType(1, b"ab"))
    with pytest.raises(ValueError, match="0xd5"):
        _msgpack.unpackb(ext)
    for bad in (np.float32(1.0), object(), {1, 2}):
        with pytest.raises(ValueError):
            _msgpack.packb(bad)
    with pytest.raises(ValueError, match="truncated"):
        _msgpack.unpackb(msgpack.packb([1, 2, 3])[:-1])
    with pytest.raises(ValueError, match="extra data"):
        _msgpack.unpackb(msgpack.packb(1) + b"\x01")


def test_msgpack_codec_on_the_registrys_metadata(tmp_path):
    """The blob the JAX package's registry writes (dtypes table, LSTM
    config, EVT tail, eps, gamma, version) decodes to what msgpack
    decodes, and encodes back to the same bytes."""
    from repro.serving import LSTMForecaster, ModelRegistry

    fc = LSTMForecaster(cfg=RNN_J, params=TREES[0][1])
    fc.calibrate(np.random.default_rng(0).standard_normal(
        (64, RNN_J.window, RNN_J.input_dim)).astype(np.float32))
    reg = ModelRegistry()
    reg.register("m", fc, version=7)
    path = str(tmp_path / "r.npz")
    reg.save("m", path)
    with np.load(path) as z:
        blob = z[jio._META_KEY].tobytes()
    got = _msgpack.unpackb(blob)
    assert got == msgpack.unpackb(blob, raw=False)
    assert got["user"]["version"] == 7 and got["user"]["kind"] == "lstm"
    assert _msgpack.packb(got) == blob
