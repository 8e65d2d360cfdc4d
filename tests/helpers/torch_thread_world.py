"""Simulated worlds for the port's sync: ranks as threads of one process.

:class:`ThreadWorld` runs ``fn(rank, comm)`` for every rank on its own
thread; each rank's ``comm`` is a communicator (``torch.distributed``'s
``all_reduce``, ``all_gather``, ``get_world_size``, ``get_rank``) whose
collectives meet at a barrier. A reduction runs over the ranks' tensors in
rank order (``((r0 + r1) + r2) + r3``), as the JAX package's ``psum``
under ``jax.vmap`` adds them on the CPU. Rank 0 records each collective.
While the ranks run, the port's process-wide ``gather_sequence_lock`` is
lifted: it serializes the sequences of one process, and these ranks are
threads of one process that must meet inside their sequences.

:class:`FakeWorld` is one rank of a world whose other ranks hold the same
tensors (a sum multiplies by the world size), with faults to inject: a
collective, picked by a predicate, that hangs or raises.
"""
import contextlib
import threading
import time

import torch
import torch.distributed as dist


def _reduce(tensors, op):
    out = tensors[0].clone()
    for t in tensors[1:]:
        if op == dist.ReduceOp.SUM:
            out = out + t
        elif op == dist.ReduceOp.MAX:
            out = torch.maximum(out, t)
        elif op == dist.ReduceOp.MIN:
            out = torch.minimum(out, t)
        else:
            raise ValueError(op)
    return out


class ThreadWorld:
    def __init__(self, n, timeout_s=60.0):
        self.n = n
        self.barrier = threading.Barrier(n, timeout=timeout_s)
        self.slots = [None] * n
        self.result = None
        self.calls = []

    def comm(self, rank):
        return _RankComm(self, rank)

    def run(self, fn):
        """``[fn(rank, comm) for every rank]``, each on its own thread; a rank
        that raises makes this raise."""
        out, errors = [None] * self.n, [None] * self.n

        def body(rank):
            try:
                out[rank] = fn(rank, self.comm(rank))
            except BaseException as err:  # noqa: BLE001 — re-raised below
                errors[rank] = err
                self.barrier.abort()

        from metrics_tpu_torch.parallel import sync

        threads = [threading.Thread(target=body, args=(r,), daemon=True) for r in range(self.n)]
        lock, sync.gather_sequence_lock = sync.gather_sequence_lock, contextlib.nullcontext()
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
        finally:
            sync.gather_sequence_lock = lock
        # the first cause, not the ranks that the abort woke
        for err in sorted((e for e in errors if e is not None), key=lambda e: isinstance(e, threading.BrokenBarrierError)):
            raise err
        return out


class _RankComm:
    def __init__(self, world, rank):
        self.world = world
        self.rank = rank

    def get_world_size(self, group=None):
        return self.world.n

    def get_rank(self, group=None):
        return self.rank

    def all_reduce(self, tensor, op=dist.ReduceOp.SUM, group=None):
        w = self.world
        w.slots[self.rank] = tensor.clone()
        w.barrier.wait()
        if self.rank == 0:
            w.calls.append(("all_reduce", tensor.dtype, str(op).split(".")[-1], tensor.numel()))
            w.result = _reduce(w.slots, op)
        w.barrier.wait()
        tensor.copy_(w.result)
        w.barrier.wait()

    def all_gather(self, parts, tensor, group=None):
        w = self.world
        w.slots[self.rank] = tensor.clone()
        w.barrier.wait()
        if self.rank == 0:
            w.calls.append(("all_gather", tensor.dtype, None, tensor.numel()))
        for part, slot in zip(parts, w.slots):
            part.copy_(slot)
        w.barrier.wait()


class FakeWorld:
    """One rank (``rank``) of a world of ``n`` whose other ranks hold the
    same tensors. ``hang``/``fail`` are predicates ``(name, tensor) ->
    bool`` that pick the collectives which hang for ``hang_s`` or raise."""

    def __init__(self, n=2, rank=0, hang=None, fail=None, hang_s=30.0):
        self.n, self.rank = n, rank
        self.hang, self.fail, self.hang_s = hang, fail, hang_s
        self.calls = []

    def get_world_size(self, group=None):
        return self.n

    def get_rank(self, group=None):
        return self.rank

    def _faults(self, name, tensor):
        self.calls.append((name, tensor.dtype))
        if self.hang is not None and self.hang(name, tensor):
            time.sleep(self.hang_s)
        if self.fail is not None and self.fail(name, tensor):
            raise ConnectionError(f"{name} failed")

    def all_reduce(self, tensor, op=dist.ReduceOp.SUM, group=None):
        self._faults("all_reduce", tensor)
        if op == dist.ReduceOp.SUM:
            tensor.mul_(self.n)

    def all_gather(self, parts, tensor, group=None):
        self._faults("all_gather", tensor)
        for part in parts:
            part.copy_(tensor)
