"""The rolling checkpoint backend of ``TPU.CKPT_BACKEND orbax`` (port of
``udp_pose_tpu/utils/orbax_ckpt.py``), written with torch alone: it uses
no orbax.

The default backend (:mod:`.checkpoint`) writes ``checkpoint.pth`` in the
step loop's thread.  This one keeps orbax's manager semantics for the
rolling train-state checkpoint:

* **asynchronous commit**: :meth:`OrbaxBackend.save` snapshots the model's
  state dict, the optimizer's and the scheduler's to host memory and
  returns: the card's tensors are copied into pinned host buffers on
  the current stream without waiting (later steps on that stream run
  after the copies), host tensors are cloned.  A background thread
  waits for the copies, writes ``orbax/<step>/`` under a temporary name
  and renames it, so that a step directory appears whole or not at all.
  One save is in flight at a time: a save first waits for the previous
  one.
* **retention**: the newest ``TPU.CKPT_MAX_TO_KEEP`` steps are kept.

Its scope is the JAX module's: the rolling checkpoint only (the
``checkpoint.pth`` role in epoch mode, the ``iter-*.pth`` role in RSN's
iteration mode); ``model_best`` and ``final_state`` stay plain weight
files.  orbax's per-shard parallel IO has no counterpart: the state is
replicated on every rank of a data-parallel run, so rank 0 is the one
writer, and every rank reads after a barrier.
"""

from __future__ import annotations

import copy
import json
import os
import shutil
import threading

import torch

from ..parallel.multihost import barrier, is_writer
from .checkpoint import restore_train_state, train_payload

STATE_FILE = "state.pth"
META_FILE = "meta.json"


def _to_host(obj):
    """A copy of ``obj`` that the run cannot change: the card's tensors
    copied into new pinned host tensors without waiting (contiguous),
    host tensors cloned, containers rebuilt, everything else
    deep-copied."""
    if torch.is_tensor(obj):
        obj = obj.detach()
        if obj.device.type != "cuda":
            return obj.clone()
        out = torch.empty(obj.shape, dtype=obj.dtype, pin_memory=True)
        return out.copy_(obj, non_blocking=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return copy.deepcopy(obj)


def _json_meta(meta):
    """The JAX module's meta encoding: bools and integers as int, the
    rest as float."""
    return {k: (int(v) if isinstance(v, bool) or hasattr(v, "__index__")
                else float(v)) for k, v in meta.items()}


class OrbaxBackend:
    """Rolling train-state checkpoints in ``<output_dir>/orbax/<step>/``.

    ``step`` is the save key: the optimizer's step count, in epoch mode
    and in iteration mode alike (monotonic either way); a second save at
    the same step replaces the first."""

    def __init__(self, output_dir, max_to_keep: int = 2):
        self.root = os.path.abspath(os.path.join(str(output_dir), "orbax"))
        if is_writer():
            os.makedirs(self.root, exist_ok=True)
        self.max_to_keep = int(max_to_keep)
        self._thread = None
        self._error = None

    def steps(self):
        """The committed steps, oldest first."""
        if not os.path.isdir(self.root):
            return []
        return sorted(int(n) for n in os.listdir(self.root) if n.isdigit())

    def latest_step(self):
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, model, state, meta: dict):
        """Snapshot ``model``'s and ``state``'s tensors to the host, start
        the commit of step ``state.step`` with ``meta`` and return its
        directory (rank 0 writes; another rank only returns it)."""
        self.wait()
        step = int(state.step)
        if not is_writer():
            return os.path.join(self.root, str(step))
        snapshot = _to_host(train_payload(model, state,
                                          weights=model.state_dict()))
        # every card the model lives on (a pipelined model's stages)
        copied = [torch.cuda.current_stream(d).record_event()
                  for d in {t.device for t in model.state_dict().values()}
                  if d.type == "cuda"]
        self._thread = threading.Thread(
            target=self._commit,
            args=(step, snapshot, copied, _json_meta(meta)),
            name=f"ckpt-commit-{step}")
        self._thread.start()
        return os.path.join(self.root, str(step))

    def _commit(self, step, snapshot, copied, meta):
        try:
            for event in copied:
                event.synchronize()
            final = os.path.join(self.root, str(step))
            tmp = f"{final}.tmp"
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            torch.save(snapshot, os.path.join(tmp, STATE_FILE))
            with open(os.path.join(tmp, META_FILE), "w") as f:
                json.dump(meta, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
            for old in self.steps()[:-self.max_to_keep]:
                shutil.rmtree(os.path.join(self.root, str(old)))
        except BaseException as e:          # raised by wait()
            self._error = e

    def wait(self):
        """Block until the save in flight has committed (before the run
        exits: at its end or on preemption); raise its error, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def close(self):
        self.wait()

    def load(self, model, state, device):
        """Restore ``model`` and ``state`` from the latest step (tensors
        mapped to ``device``); returns its meta, or None when no step
        exists.  Every rank reads, after a barrier."""
        self.wait()
        barrier()
        step = self.latest_step()
        if step is None:
            return None
        d = os.path.join(self.root, str(step))
        # the backend's own file, not outside input
        restore_train_state(torch.load(os.path.join(d, STATE_FILE),
                                       map_location=device,
                                       weights_only=False), model, state)
        with open(os.path.join(d, META_FILE)) as f:
            return json.load(f)


def load_any(backend, model, state, iter_mode: bool, device):
    """``AUTO_RESUME`` through the backend: the tuples the default
    backend's loaders return, (begin_epoch, best_perf, step_in_epoch) in
    epoch mode and the iteration to go on from in iteration mode (the
    JAX ``load_any`` without the state, which is restored in place)."""
    meta = backend.load(model, state, device)
    if iter_mode:
        return 0 if meta is None else int(meta.get("iteration", -1)) + 1
    if meta is None:
        return 0, 0.0, 0
    return (int(meta.get("epoch", -1)) + 1, float(meta.get("perf", 0.0)),
            int(meta.get("step_in_epoch", 0)))
