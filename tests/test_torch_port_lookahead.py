"""The Trainer's one-batch look-ahead (`Trainer._prepared_batches`, the
JAX Trainer's counterpart) on the CPU, at the tiny geometry of
tests/test_torch_port_trainer.py and on one intra-op thread (PyTorch's
multithreaded CPU backward is not bit-reproducible from run to run):

  * an epoch through the look-ahead gives the same per-step metrics and
    final weights, bit for bit, as the same epoch uploaded synchronously;
  * `model_inputs(out=...)` fills the given buffers and equals
    `model_inputs`;
  * an epoch abandoned by an exception (the fail-safe restart, the NaN
    abort) leaves no look-ahead or loader thread alive;
  * a loader error reaches the training loop.
"""
import threading

import numpy as np
import pytest
import torch

from multi_modal_tracking_torch.train.data.loader import batch_to_model_inputs
from multi_modal_tracking_torch.train.train_step import input_buffers, model_inputs
from multi_modal_tracking_torch.train.trainer import Trainer
from tests.test_torch_port_trainer import TINY, _cfg
from tests.torch_port_threads import one_torch_thread  # noqa: F401 (autouse fixture)


def _trainer(tmp_path, seed=0):
    return Trainer("asymmetric_shared_ce", _cfg(), save_dir=str(tmp_path), device="cpu",
                   seed=seed, spec_overrides=TINY, dtype=torch.float32)


def _synchronous(tr):
    """The epoch loop's batches converted and uploaded in the loop itself."""
    def batches(loader):
        for batch in loader:
            inputs = model_inputs(batch_to_model_inputs(batch, rgbt=True), tr.device)
            yield inputs, inputs["gt_xywh"].shape[0]
    return batches


def _threads():
    """The look-ahead's and the loaders' threads that are alive."""
    return {t.name for t in threading.enumerate()
            if t.name.startswith(("trainer-lookahead", "loader-"))}


def test_epoch_equals_synchronous_upload(tmp_path):
    ahead, sync = _trainer(tmp_path / "a"), _trainer(tmp_path / "s")
    sync._prepared_batches = _synchronous(sync)
    for tr in (ahead, sync):
        tr.train(max_epochs=2)
    assert len(ahead.history) == 2 and ahead.history == sync.history
    assert len(ahead.input_waits) == 2 and all(w is None for _, w in ahead.input_waits)
    sa, ss = ahead.model.state_dict(), sync.model.state_dict()
    assert sa.keys() == ss.keys() and all(torch.equal(sa[k], ss[k]) for k in sa)


def test_model_inputs_out_equals_model_inputs(tmp_path):
    tr = _trainer(tmp_path)
    host = batch_to_model_inputs(next(iter(tr.train_loader)), rgbt=True)
    want = model_inputs(host, "cpu")
    bufs = input_buffers(host)
    got = model_inputs(host, "cpu", out=bufs)
    assert got.keys() == want.keys() == bufs.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype == torch.float32
        assert got[k].data_ptr() == bufs[k].data_ptr()
        assert torch.equal(got[k], want[k]), k
    assert want["s"].shape == (4, 176, 176, 3) and want["gt_xywh"].shape == (2, 4)


def test_abandoned_epoch_leaks_no_thread(tmp_path):
    """An exception injected at step 2 under the fail-safe restart, then a
    NaN abort: after each, no thread that the epoch started is alive."""
    tr = _trainer(tmp_path)
    step, calls = tr._step, []

    def failing(*args, **kwargs):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("injected failure at step 2")
        return step(*args, **kwargs)

    tr._step = failing
    tr.train(max_epochs=1, fail_safe=True)
    assert tr.epoch == 1 and len(calls) == 4
    assert _threads() == set(), _threads()
    tr._step = step
    tr.optimizer.base_lr = float("nan")
    tr.epoch = 1
    with pytest.raises(FloatingPointError, match="non-finite loss"):
        tr.cycle_dataset()
    assert _threads() == set(), _threads()


def test_loader_error_reaches_the_loop(tmp_path):
    tr = _trainer(tmp_path)

    def broken():
        yield next(iter(tr.train_loader))
        raise OSError("injected loader failure")

    class Broken:
        name = "train"

        def __len__(self):
            return 2

        def __iter__(self):
            return broken()

    with pytest.raises(OSError, match="injected loader failure"):
        tr.cycle_dataset(Broken())
    assert len(tr.history) == 0 and len(tr.input_waits) == 1
    assert _threads() == set(), _threads()


def test_upload_buffers_are_float32(tmp_path):
    tr = _trainer(tmp_path)
    host = batch_to_model_inputs(next(iter(tr.train_loader)), rgbt=True)
    host = {k: v.astype(np.float64) for k, v in host.items()}
    bufs = input_buffers(host)
    got = model_inputs(host, "cpu", out=bufs)
    want = model_inputs(host, "cpu")
    assert all(got[k].dtype == torch.float32 and torch.equal(got[k], want[k]) for k in want)
