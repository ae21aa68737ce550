"""Checkpoint/resume — port of ``kubeflow_tpu/training/checkpoint.py``.

The reference writes orbax checkpoints; the port, which imports no orbax,
writes its own format. A step is the directory ``<dir>/<step>`` holding
``state.pt``, a ``torch.save`` of CPU copies of the state tree (nested
dicts and lists of tensors and Python numbers), read back with
``torch.load(weights_only=True)``. A save writes ``<dir>/<step>.tmp-<pid>``
and renames it into place, so a step directory is always complete when it
exists; a crash mid-write leaves only a tmp directory, which the next
Checkpointer removes.

The reference's failure policy carries over: keep-rotation of the newest
``keep`` steps; an unreadable newest step is quarantined (renamed aside,
its bytes kept) and an older one restored; a structural mismatch on every
step means a fresh start (``None``, with the reason printed); an I/O
failure with no readable step raises. Its chaos points carry over too
(``chaos``): ``checkpoint.save`` (``mode=corrupt``) tears a save after it
has committed, ``checkpoint.restore`` fails a restore with ``OSError``.

Under a torch.distributed group of several processes (the data-parallel
TrainLoop, whose state is equal on every rank, and the sharded
LMTrainLoop, whose ``state_tree`` gathers the full tree and is therefore
called on every rank), rank 0 writes and every rank meets the others at
a barrier after each save, so a save has committed when ``maybe_save``
returns on any rank; rank 0 restores (with the quarantine and the chaos
points, as at world 1) and every other rank then loads the step rank 0
restored.
"""

from __future__ import annotations

import os
import shutil
import threading
from typing import Any, List, Optional, Tuple

import torch
import torch.distributed as dist

from .. import chaos
from ..runtime.rendezvous import rank_world

QUARANTINE_PREFIX = "quarantine-"
STATE_FILE = "state.pt"


class StructureMismatch(ValueError):
    """The stored tree does not have the target's structure."""


def corrupt_step_dir(directory: str, step: int) -> int:
    """Simulate a torn checkpoint write: truncate every regular file under
    the step's directory to half its size. Returns the number of files
    damaged. Used by tests."""
    step_dir = os.path.join(os.path.abspath(directory), str(step))
    damaged = 0
    for root, _, files in os.walk(step_dir):
        for fname in files:
            path = os.path.join(root, fname)
            try:
                size = os.path.getsize(path)
                with open(path, "r+b") as f:
                    f.truncate(size // 2)
                damaged += 1
            except OSError:
                continue
    return damaged


def _to_cpu(tree: Any) -> Any:
    """A copy of ``tree`` whose tensors are CPU copies: taken before the
    caller's next in-place update, so an async write never serializes a
    half-updated state."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def _check_structure(got: Any, want: Any, path: str = "") -> None:
    """Raise StructureMismatch unless ``got`` has ``want``'s structure:
    the same dict keys and list lengths, tensors of the same shape and
    dtype, and other leaves of the same type."""
    where = path or "root"
    if isinstance(want, torch.Tensor):
        if not (isinstance(got, torch.Tensor) and got.shape == want.shape
                and got.dtype == want.dtype):
            desc = (f"{tuple(got.shape)} {got.dtype}"
                    if isinstance(got, torch.Tensor) else type(got).__name__)
            raise StructureMismatch(
                f"{where}: stored {desc}, want {tuple(want.shape)} "
                f"{want.dtype}")
    elif isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            have = sorted(map(str, got)) if isinstance(got, dict) \
                else type(got).__name__
            raise StructureMismatch(f"{where}: stored keys {have}, want "
                                    f"{sorted(map(str, want))}")
        for k in want:
            _check_structure(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        if not isinstance(got, (list, tuple)) or len(got) != len(want):
            raise StructureMismatch(f"{where}: stored length differs")
        for i, (g, w) in enumerate(zip(got, want)):
            _check_structure(g, w, f"{path}/{i}")
    elif type(got) is not type(want):
        raise StructureMismatch(f"{where}: stored {type(got).__name__}, "
                                f"want {type(want).__name__}")


def _placed_like(got: Any, want: Any) -> Any:
    """``got`` with each tensor moved to the device of ``want``'s."""
    if isinstance(want, torch.Tensor):
        return got.to(want.device)
    if isinstance(want, dict):
        return {k: _placed_like(got[k], want[k]) for k in want}
    if isinstance(want, (list, tuple)):
        return type(want)(_placed_like(g, w) for g, w in zip(got, want))
    return got


class Checkpointer:
    """Saves every ``save_every`` steps (plus on demand), keeps the newest
    ``keep`` steps, and restores the newest readable one on resume.

    A state is a tree, or an object with ``state_tree()`` and
    ``load_state_tree(tree)`` (``training.loop.TrainState``). With
    ``async_save`` the write runs on a background thread after the
    state has been copied to the host; ``wait()`` joins it and raises
    what it raised.
    """

    def __init__(self, directory: str, save_every: int = 100, keep: int = 2,
                 async_save: bool = True):
        self.directory = os.path.abspath(directory)
        self.save_every = save_every
        self.keep = keep
        self.rank, self.world = rank_world()
        # Over several ranks rank 0's write completes before the barrier.
        self.async_save = async_save and self.world == 1
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        if self.rank == 0:
            os.makedirs(self.directory, exist_ok=True)
            for name in os.listdir(self.directory):
                if ".tmp-" in name:   # a write a crash interrupted
                    shutil.rmtree(os.path.join(self.directory, name),
                                  ignore_errors=True)
        self._barrier()

    def _barrier(self) -> None:
        if self.world > 1:
            dist.barrier()

    # -- listing -----------------------------------------------------------
    def all_steps(self) -> List[int]:
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit()
                      and os.path.isdir(os.path.join(self.directory, n)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # -- saving ------------------------------------------------------------
    def maybe_save(self, step: int, state: Any, force: bool = False) -> bool:
        if not force and (self.save_every <= 0 or step % self.save_every != 0):
            return False
        self.wait()
        self._barrier()   # every rank sees the directory before the write
        if step in self.all_steps():
            return False   # this step is already durable
        # Every rank builds the tree: for a sharded state it is a gather.
        tree = state.state_tree() if hasattr(state, "state_tree") else state
        if self.rank == 0:
            self._save(step, tree)
        self._barrier()
        return True

    def _save(self, step: int, tree: Any) -> None:
        snapshot = _to_cpu(tree)
        if self.async_save:
            self._writer = threading.Thread(
                target=self._write_guarded, args=(step, snapshot),
                daemon=True, name=f"kfx-ckpt-{step}")
            self._writer.start()
        else:
            self._write(step, snapshot)
        # Fault point: corrupt THIS save after it commits (a torn write
        # that still looks finalized). Join the writer first: damaging a
        # write still in flight would race it, not model a crash after
        # commit.
        if chaos.draw("checkpoint.save", target=f"step-{step}") is not None:
            self.wait()
            n = corrupt_step_dir(self.directory, step)
            print(f"chaos_corrupt_checkpoint step={step} files={n}",
                  flush=True)

    def _write_guarded(self, step: int, snapshot: Any) -> None:
        try:
            self._write(step, snapshot)
        except BaseException as e:  # re-raised by wait()
            self._error = e

    def _write(self, step: int, snapshot: Any) -> None:
        final = os.path.join(self.directory, str(step))
        tmp = f"{final}.tmp-{os.getpid()}"
        os.makedirs(tmp, exist_ok=True)
        path = os.path.join(tmp, STATE_FILE)
        with open(path, "wb") as f:
            torch.save(snapshot, f)
            f.flush()
            os.fsync(f.fileno())
        os.rename(tmp, final)
        for old in self.all_steps()[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.directory, str(old)),
                          ignore_errors=True)

    def wait(self) -> None:
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def close(self) -> None:
        self.wait()

    # -- restoring ---------------------------------------------------------
    def _quarantine(self, step: int, reason: str) -> None:
        """Move an unreadable step aside (its bytes kept; rotation and
        latest_step no longer see it); a second quarantine of the same
        step gets a numbered suffix."""
        src = os.path.join(self.directory, str(step))
        dst = os.path.join(self.directory, f"{QUARANTINE_PREFIX}{step}")
        n = 2
        while os.path.isdir(dst):
            dst = os.path.join(self.directory,
                               f"{QUARANTINE_PREFIX}{step}-{n}")
            n += 1
        try:
            os.rename(src, dst)
        except OSError:
            pass
        print(f"checkpoint_quarantined step={step} reason={reason} "
              f"dir={dst}", flush=True)

    def restore_latest(self, target: Any) -> Optional[Any]:
        """Restore the newest readable checkpoint into ``target``'s
        structure (a tree, or a state with ``load_state_tree``, which is
        filled in place and returned).

        Failure policy, newest step first:
          * a step that restores wins; every NEWER step that failed is
            quarantined;
          * every step fails structurally -> None (a fresh start), with
            the reason printed;
          * otherwise (unreadable files and no readable step) raise:
            retraining from step 0 on a recoverable storage error would
            let the keep-rotation delete good checkpoints.
        """
        self.wait()
        # Every rank builds the structure: for a sharded state a gather.
        want = target.state_tree() if hasattr(target, "state_tree") \
            else target
        if self.world == 1:
            return self._restore_newest(target, want)[1]
        # Rank 0 restores; the others load the step it restored.
        outcome: List[Any] = [None]
        restored = error = None
        if self.rank == 0:
            try:
                step, restored = self._restore_newest(target, want)
                outcome[0] = ("ok", step)
            except Exception as e:  # re-raised here, reported to the rest
                error = e
                outcome[0] = ("error", f"{type(e).__name__}: {e}")
        dist.broadcast_object_list(outcome, src=0)
        kind, detail = outcome[0]
        if error is not None:
            raise error
        if kind == "error":
            raise RuntimeError(f"rank 0 failed to restore from "
                               f"{self.directory}: {detail}")
        if self.rank == 0 or detail is None:
            return restored
        return self._load_step(detail, target, want)

    def _load_step(self, step: int, target: Any, want: Any) -> Any:
        """Step ``step`` loaded into ``target``, whose tree is ``want``
        (raises what torch.load or the structure check raise)."""
        got = torch.load(os.path.join(self.directory, str(step), STATE_FILE),
                         map_location="cpu", weights_only=True)
        _check_structure(got, want)
        if hasattr(target, "load_state_tree"):
            return target.load_state_tree(got)
        return _placed_like(got, want)

    def _restore_newest(self, target: Any, want: Any
                        ) -> Tuple[Optional[int], Any]:
        """(step, restored state) of restore_latest's policy, ``want``
        being ``target``'s tree; (None, None) for a fresh start."""
        chaos.fail_or_delay("checkpoint.restore", OSError,
                            f"restore from {self.directory}")
        steps = sorted(self.all_steps(), reverse=True)
        if not steps:
            return None, None
        failed: List[Tuple[int, str]] = []
        all_structural = True
        last_error: Optional[BaseException] = None
        for step in steps:
            path = os.path.join(self.directory, str(step), STATE_FILE)
            try:
                got = torch.load(path, map_location="cpu", weights_only=True)
                _check_structure(got, want)
            except StructureMismatch as e:
                reason = f"current:{type(e).__name__}"
                last_error = e
            except Exception as e:  # unreadable: torn write, I/O
                reason = f"current:{type(e).__name__}"
                last_error = e
                all_structural = False
            else:
                for bad_step, why in failed:
                    self._quarantine(bad_step, why)
                if hasattr(target, "load_state_tree"):
                    return step, target.load_state_tree(got)
                return step, _placed_like(got, want)
            failed.append((step, reason))
            print(f"checkpoint_unreadable step={step} tried=[{reason}] "
                  f"— trying older step", flush=True)
        if all_structural:
            print(f"checkpoint_restore_incompatible "
                  f"steps={[s for s, _ in failed]} — starting fresh "
                  f"({last_error})", flush=True)
            return None, None
        raise RuntimeError(
            f"no retained checkpoint in {self.directory} is readable "
            f"(steps {[s for s, _ in failed]}); refusing to restart from "
            f"step 0 on what may be a recoverable storage error"
        ) from last_error
