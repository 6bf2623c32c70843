"""Checkpoints: a run directory's checkpoint that gcl_tpu wrote (flax
msgpack) loads in the port, which decodes msgpack itself; the port's own
save -> load round trip. Everything is exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from gcl_tpu.train.checkpoint import load_checkpoint as j_load_checkpoint
from gcl_tpu.train.checkpoint import save_checkpoint as j_save_checkpoint
from gcl_tpu_torch.models.resunet import ResUNetFatBNEXP
from gcl_tpu_torch.models.weights import (flax_to_state_dict,
                                          random_state_dict,
                                          state_dict_to_flax)
from gcl_tpu_torch.train.checkpoint import (load_checkpoint,
                                            msgpack_restore,
                                            save_checkpoint)


def _same_tree(a, b):
    if isinstance(b, dict):
        assert isinstance(a, dict) and a.keys() == b.keys()
        for k in b:
            _same_tree(a[k], b[k])
    elif isinstance(b, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b, equal_nan=True)
    elif isinstance(b, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same_tree(x, y)
    else:
        assert type(a) is type(b) and (a == b or a != a and b != b), (a, b)


def test_decoder_reads_what_flax_writes():
    """Every msgpack form flax writes: short and long strings, maps and
    lists past 16 and 65,535 entries, integers of every width and sign,
    floats, booleans, nil, bytes, and flax's ndarray and numpy-scalar ext
    types (bf16 included)."""
    rng = np.random.RandomState(0)
    tree = {
        "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32, 2 ** 63,
                 -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31 - 1],
        "floats": [0.5, -1e300, float("nan"), float("inf")],
        "flags": [True, False, None],
        "names": ["", "a" * 31, "b" * 32, "c" * 300, "d" * 70000, "ü"],
        "blob": b"\x00\x01" * 200,
        "many": {str(i): i for i in range(40)},
        "long": list(range(70000)),
        "arrays": {"f32": rng.randn(3, 5).astype(np.float32),
                   "f64": rng.randn(4), "i32": np.arange(7, dtype=np.int32),
                   "u8": np.arange(5, dtype=np.uint8),
                   "bool": rng.rand(6) > 0.5,
                   "empty": np.zeros((0, 3), np.float32),
                   "scalar0d": np.asarray(3.5, np.float32)},
        "np_scalar": np.float32(2.25),
    }
    blob = serialization.msgpack_serialize(tree)
    _same_tree(msgpack_restore(blob), serialization.msgpack_restore(blob))
    bf = serialization.msgpack_serialize(
        {"w": jnp.asarray(rng.randn(4, 3), jnp.bfloat16)})
    np.testing.assert_array_equal(
        msgpack_restore(bf)["w"],
        np.asarray(serialization.msgpack_restore(bf)["w"], np.float32))
    with pytest.raises(ValueError):
        msgpack_restore(blob[:-3])


@pytest.fixture(scope="module")
def state():
    model = ResUNetFatBNEXP(1, 32, bn_momentum=0.05, normalize_feature=True,
                            conv1_kernel_size=5, D=3)
    return random_state_dict(model, seed=2)


def test_gcl_tpu_checkpoint_loads_bit_equal(tmp_path, state):
    params, stats = state_dict_to_flax(state)
    opt = {"trace": {"conv1": {"kernel": np.full_like(
        params["conv1"]["kernel"], 0.5)}}, "count": np.int32(3)}
    path = str(tmp_path / "best_val_checkpoint.pth")
    cfg = {"model": "ResUNetFatBNEXP", "voxel_size": 0.3, "lr": 0.1,
           "use_old_pose": True, "weights": None, "drop": [1, 2]}
    j_save_checkpoint(path, epoch=7, params=params, batch_stats=stats,
                      opt_state=opt, config=cfg, best_val=0.25,
                      best_val_epoch=5, best_val_metric="feat_match_ratio")
    got = load_checkpoint(path)
    want = flax_to_state_dict(params, stats)
    assert got["state_dict"].keys() == want.keys() == state.keys()
    for k in want:
        assert got["state_dict"][k].dtype == want[k].dtype
        assert torch.equal(got["state_dict"][k], want[k])
    ref = j_load_checkpoint(path)
    for k in ("epoch", "scheduler", "config", "best_val", "best_val_epoch",
              "best_val_metric", "optimizer"):
        _same_tree(got[k], ref[k])
    assert got["config"] == {k: v for k, v in cfg.items() if k != "drop"}


def test_port_checkpoint_round_trip(tmp_path, state):
    model = ResUNetFatBNEXP(1, 32, bn_momentum=0.05, normalize_feature=True,
                            conv1_kernel_size=5, D=3)
    model.load_state_dict(state)
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.8)
    path = str(tmp_path / "checkpoint.pth")
    save_checkpoint(path, epoch=3, state_dict=model.state_dict(),
                    optimizer=opt.state_dict(), config={"lr": 0.1,
                                                        "skip": [1]},
                    best_val=np.inf, best_val_epoch=np.inf,
                    best_val_metric="feat_match_ratio")
    got = load_checkpoint(path)
    assert got["epoch"] == 3 and got["config"] == {"lr": 0.1}
    assert got["best_val_epoch"] == -(2 ** 31)
    for k, v in state.items():
        assert torch.equal(got["state_dict"][k], v)
    opt.load_state_dict(got["optimizer"])
