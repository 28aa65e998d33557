"""Remote-path branch of ``utils/file.py`` (``utils/File.scala:25`` HDFS/S3
equivalent) exercised against a fake in-memory fsspec, so the ``gs://``
code path is covered in the zero-egress test environment."""

import io
import sys
import types

import pytest

from bigdl_tpu.utils import file as file_mod


class _FakeOpenFile:
    """Mirrors fsspec.core.OpenFile: ``fsspec.open(path, mode).open()``."""

    def __init__(self, store, path, mode):
        self.store, self.path, self.mode = store, path, mode

    def open(self):
        if "r" in self.mode:
            if self.path not in self.store:
                raise FileNotFoundError(self.path)
            return io.BytesIO(self.store[self.path])
        store, path = self.store, self.path
        buf = io.BytesIO()
        orig_close = buf.close

        def close():
            store[path] = buf.getvalue()
            orig_close()

        buf.close = close
        return buf


@pytest.fixture
def fake_fsspec(monkeypatch):
    store = {}
    mod = types.ModuleType("fsspec")
    mod.open = lambda path, mode: _FakeOpenFile(store, path, mode)
    monkeypatch.setitem(sys.modules, "fsspec", mod)
    return store


def test_remote_round_trip(fake_fsspec):
    file_mod.save(b"\x00payload\xff", "gs://bucket/dir/model.btpu",
                  overwrite=True)
    assert fake_fsspec["gs://bucket/dir/model.btpu"] == b"\x00payload\xff"
    assert file_mod.load("gs://bucket/dir/model.btpu") == b"\x00payload\xff"


def test_remote_missing_file_raises(fake_fsspec):
    with pytest.raises(FileNotFoundError):
        file_mod.load("gs://bucket/absent")


def test_remote_without_fsspec_is_a_clear_error(monkeypatch):
    monkeypatch.setitem(sys.modules, "fsspec", None)
    with pytest.raises(RuntimeError, match="fsspec"):
        file_mod.load("gs://bucket/x")


def test_remote_save_type_check(fake_fsspec):
    with pytest.raises(TypeError):
        file_mod.save({"not": "bytes"}, "gs://bucket/x", overwrite=True)


# -- integration tier (round 4): the whole checkpoint/resume cycle over a
# -- remote scheme, the in-process analogue of integration/HdfsSpec.scala:46

@pytest.fixture
def memfs():
    """Real fsspec MemoryFileSystem, wiped per test."""
    fsspec = pytest.importorskip("fsspec")
    fs = fsspec.filesystem("memory")
    yield fs
    try:
        fs.rm("/", recursive=True)
    except Exception:
        pass


def test_checkpoint_resume_over_remote_scheme(memfs):
    """Train with a memory:// checkpoint dir, then resume a second run
    from the remote checkpoint — the reference trains against HDFS paths
    the same way (integration/HdfsSpec.scala:46; File.scala:67-171)."""
    import numpy as np

    import bigdl_tpu.nn as nn
    import bigdl_tpu.optim as optim
    from bigdl_tpu.dataset.sample import Sample
    from bigdl_tpu.nn.module import state_dict
    from bigdl_tpu.utils.rng import RNG
    from bigdl_tpu.utils.serializer import load_module, load_optim_method

    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 4)).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.int64)
    samples = [Sample(x[i], np.int64(y[i])) for i in range(64)]

    RNG.set_seed(31)
    m = nn.Sequential(nn.Linear(4, 8), nn.Tanh(), nn.Linear(8, 2),
                      nn.LogSoftMax())
    ckpt = "memory://bigdl_ckpt/run1"
    o = optim.LocalOptimizer(m, samples, nn.ClassNLLCriterion(),
                             batch_size=16,
                             end_trigger=optim.Trigger.max_iteration(4))
    o.set_optim_method(optim.Adam(learning_rate=0.01))
    o.set_checkpoint(ckpt, optim.Trigger.several_iteration(2))
    o.overwrite_checkpoint()
    o.optimize()

    mfile = optim.Optimizer.get_latest_file(ckpt, "model")
    ofile = optim.Optimizer.get_latest_file(ckpt, "optimMethod")
    assert mfile == "memory://bigdl_ckpt/run1/model.4", mfile
    m2 = load_module(mfile)
    om2 = load_optim_method(ofile)
    p1, p2 = state_dict(m), state_dict(m2)
    for k in p1:
        np.testing.assert_allclose(np.asarray(p1[k]), np.asarray(p2[k]),
                                   rtol=1e-6)
    # resume continues the iteration count from the remote state
    o2 = optim.LocalOptimizer(m2, samples, nn.ClassNLLCriterion(),
                              batch_size=16,
                              end_trigger=optim.Trigger.max_iteration(6))
    o2.set_optim_method(om2)
    o2.set_state(om2.state["driver_state"])
    o2.optimize()
    assert o2.state["neval"] == 6


@pytest.mark.slow
def test_retry_restores_from_remote_checkpoint(memfs):
    """An injected mid-training failure recovers from the memory://
    checkpoint through the retry loop (failure path + remote IO
    composed)."""
    import numpy as np

    import bigdl_tpu.nn as nn
    import bigdl_tpu.optim as optim
    from bigdl_tpu.dataset.sample import Sample
    from bigdl_tpu.utils.rng import RNG
    from tests.test_training_loop import ExceptionLayer

    rng = np.random.default_rng(1)
    x = rng.normal(size=(32, 4)).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.int64)
    samples = [Sample(x[i], np.int64(y[i])) for i in range(32)]

    RNG.set_seed(33)
    ExceptionLayer.count = 0
    model = nn.Sequential(nn.Linear(4, 8), ExceptionLayer(fail_at=6),
                          nn.Tanh(), nn.Linear(8, 2), nn.LogSoftMax())
    o = optim.LocalOptimizer(model, samples, nn.ClassNLLCriterion(),
                             batch_size=16,
                             end_trigger=optim.Trigger.max_iteration(8))
    o.set_optim_method(optim.SGD(learning_rate=0.1))
    o.set_checkpoint("memory://bigdl_ckpt/retry",
                     optim.Trigger.several_iteration(2))
    o.overwrite_checkpoint()
    o.optimize()
    assert o.state["neval"] >= 8  # completed despite the injected failure
    assert memfs.exists("/bigdl_ckpt/retry")
