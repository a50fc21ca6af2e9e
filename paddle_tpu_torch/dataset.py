"""Dataset: out-of-core file-list data pipeline.

Parity: framework/data_set.{h,cc} (Dataset :43, LoadIntoMemory :93,
GlobalShuffle :103) + fluid/dataset.py (InMemoryDataset/QueueDataset) +
the MultiSlot text format of framework/data_feed.cc:532.

Counterpart of paddle_tpu/dataset.py: the same setters
(``set_steps_per_dispatch`` included, default 8), padding and drop-last
rules, and the same order of instances — ``local_shuffle(seed)`` draws
``np.random.RandomState(seed).permutation``, so a shuffled epoch is the
JAX package's for the same seed.  Parsing runs through the native C++
parser (paddle_tpu_torch/native/, built at first use).  Variable-length
(sparse) slots are padded to the declared trailing dim of their feed var
(static shapes, as the JAX package's LoD answer; the trainer stacks K
batches of one shape).  ``global_shuffle`` exchanges instances over
``torch.distributed`` (gloo on the CPU, NCCL on cards).
``set_pipe_command`` is stored and not run (as in the JAX package):
preprocess the files instead."""
from __future__ import annotations

import os

import numpy as np

from .core.program import Variable
from .native import parse_multislot_file

__all__ = ["DatasetFactory", "DatasetBase", "InMemoryDataset",
           "QueueDataset"]


class DatasetFactory:
    def create_dataset(self, datafeed_class="QueueDataset"):
        if datafeed_class == "InMemoryDataset":
            return InMemoryDataset()
        return QueueDataset()


class DatasetBase:
    def __init__(self):
        self.batch_size = 1
        self.thread_num = 1
        self.filelist = []
        self.use_vars: list[Variable] = []
        self.drop_last = True
        self.steps_per_dispatch = 8  # steps per chunk of the trainer
        self.pad_value = 0

    def set_batch_size(self, batch_size):
        self.batch_size = batch_size

    def set_thread(self, thread_num):
        self.thread_num = thread_num

    def set_filelist(self, filelist):
        self.filelist = list(filelist)

    def set_use_var(self, var_list):
        self.use_vars = list(var_list)

    def set_pipe_command(self, cmd):
        # The reference pipes raw lines through a user command; unsupported
        # in-process — preprocess files instead.
        self.pipe_command = cmd

    def set_steps_per_dispatch(self, k):
        self.steps_per_dispatch = k

    def _slot_types(self):
        types = []
        for v in self.use_vars:
            types.append("f" if v.dtype in ("float32", "float64", "float16",
                                            "bfloat16") else "u")
        return types

    def _pad_len(self, var):
        """Fixed per-instance length for a slot = declared trailing dim."""
        if var.shape is None or len(var.shape) == 0:
            return 1
        d = var.shape[-1]
        return 1 if d in (-1, None) else int(d)

    def _parse_files(self, types):
        """Parse self.filelist, with `thread_num` parser threads when >1
        (parity: the reference's per-thread DataFeed readers,
        framework/data_feed.cc — the ctypes parser drops the GIL during
        the C++ scan, so threads genuinely overlap).  Results stream in
        filelist order, at most ``thread_num + 1`` files in flight."""
        from . import fs as _fs

        # remote (hdfs://, afs://) filelist entries localize lazily
        # INSIDE the per-file stage (parity: DataFeed reads through
        # fs.cc) — the download of file k+1 overlaps the parse of file
        # k through the same bounded thread pool.  Each fetch goes to a
        # PRIVATE temp file deleted right after parsing, so only the
        # in-flight window is ever resident on local disk (an epoch
        # over a multi-TB warehouse must not accumulate it locally) and
        # concurrent fetches of a repeated filelist entry cannot race.
        def _fetch_and_parse(path, types_):
            import tempfile as _tf

            if isinstance(path, str) and path.startswith(
                    _fs._REMOTE_SCHEMES):
                fd, tmp = _tf.mkstemp(prefix="paddle_tpu_torch_part_")
                os.close(fd)
                os.unlink(tmp)      # hadoop -get refuses existing dst
                try:
                    _fs.download(path, tmp)
                    return parse_multislot_file(tmp, types_)
                finally:
                    if os.path.exists(tmp):
                        os.unlink(tmp)
            return parse_multislot_file(path, types_)

        filelist = list(self.filelist)
        if self.thread_num > 1 and len(filelist) > 1:
            from collections import deque
            from concurrent.futures import ThreadPoolExecutor

            # bounded lookahead (thread_num + 1 in-flight files) so a slow
            # consumer doesn't force the whole dataset resident — that
            # out-of-core property is QueueDataset's reason to exist
            with ThreadPoolExecutor(self.thread_num) as pool:
                it = iter(filelist)
                dq = deque()
                try:
                    for _ in range(self.thread_num + 1):
                        p = next(it, None)
                        if p is None:
                            break
                        dq.append(pool.submit(
                            _fetch_and_parse, p, types))
                    while dq:
                        res = dq.popleft().result()
                        p = next(it, None)
                        if p is not None:
                            dq.append(pool.submit(
                                _fetch_and_parse, p, types))
                        yield res
                finally:
                    for f in dq:
                        f.cancel()
        else:
            for path in filelist:
                yield _fetch_and_parse(path, types)

    def _instances_to_batch(self, slot_arrays, start, end):
        """slot_arrays: [(values, offsets)] per slot → feed dict for
        instances [start:end), padding/truncating ragged slots."""
        feed = {}
        for var, (values, offsets) in zip(self.use_vars, slot_arrays):
            pad = self._pad_len(var)
            rows = []
            for i in range(start, end):
                vals = values[offsets[i]:offsets[i + 1]]
                if len(vals) < pad:
                    vals = np.concatenate([
                        vals,
                        np.full(pad - len(vals), self.pad_value,
                                dtype=values.dtype),
                    ])
                else:
                    vals = vals[:pad]
                rows.append(vals)
            feed[var.name] = np.stack(rows)
        return feed


class InMemoryDataset(DatasetBase):
    """Parity: fluid.InMemoryDataset — load all files, shuffle in RAM."""

    def __init__(self):
        super().__init__()
        self._slots = None  # [(values, offsets)] per slot
        self._n = 0

    def load_into_memory(self):
        types = self._slot_types()
        merged_vals = [[] for _ in types]
        merged_offs = [[0] for _ in types]
        n_total = 0
        for n, slots in self._parse_files(types):
            n_total += n
            for s, (values, offsets) in enumerate(slots):
                base = merged_offs[s][-1]
                merged_vals[s].append(values)
                merged_offs[s].extend((offsets[1:] + base).tolist())
        self._slots = [
            (np.concatenate(v) if v else np.empty(
                0, np.float32 if t == "f" else np.int64),
             np.asarray(o, dtype=np.int64))
            for v, o, t in zip(merged_vals, merged_offs, types)
        ]
        self._n = n_total

    def local_shuffle(self, seed=None):
        rng = np.random.RandomState(seed)
        perm = rng.permutation(self._n)
        new_slots = []
        for values, offsets in self._slots:
            lens = offsets[1:] - offsets[:-1]
            new_offsets = np.zeros(self._n + 1, dtype=np.int64)
            new_offsets[1:] = np.cumsum(lens[perm])
            new_values = np.empty_like(values)
            pos = 0
            for i in perm:
                cnt = lens[i]
                new_values[pos:pos + cnt] = values[offsets[i]:offsets[i] + cnt]
                pos += cnt
            new_slots.append((new_values, new_offsets))
        self._slots = new_slots

    def _pack_instances(self, idxs):
        """Serialize instances [idxs] into one byte buffer: per slot an
        int64 count, int64 per-instance lengths, then raw values."""
        parts = []
        for values, offsets in self._slots:
            lens = (offsets[idxs + 1] - offsets[idxs]).astype(np.int64)
            if len(idxs):
                vals = np.concatenate(
                    [values[offsets[i]:offsets[i + 1]] for i in idxs])
            else:
                vals = values[:0]
            parts.append(np.asarray([len(idxs)], np.int64).tobytes())
            parts.append(lens.tobytes())
            parts.append(np.ascontiguousarray(vals).tobytes())
        return b"".join(parts)

    def _unpack_instances(self, buf):
        """Inverse of _pack_instances → (n, [(values, lens)] per slot)."""
        out = []
        pos = 0
        n = None
        for values, _ in self._slots:
            cnt = int(np.frombuffer(buf, np.int64, 1, pos)[0])
            pos += 8
            lens = np.frombuffer(buf, np.int64, cnt, pos).copy()
            pos += 8 * cnt
            total = int(lens.sum())
            vals = np.frombuffer(buf, values.dtype, total, pos).copy()
            pos += total * values.dtype.itemsize
            if n is None:
                n = cnt
            out.append((vals, lens))
        return n or 0, out

    def global_shuffle(self, fleet=None, thread_num=None, seed=None):
        """Cross-rank instance exchange + local shuffle.

        Parity: framework/data_set.h:103 GlobalShuffle — the reference
        sends each record to a random trainer over the fleet RPC layer.
        Here each rank assigns every instance a uniform random
        destination rank (``RandomState(seed + 7919 * rank)``, as the
        JAX package), packs one byte buffer per destination, and the
        buffers move over the default ``torch.distributed`` group (gloo
        on the CPU, NCCL on cards): one all-gather of the sizes, then
        one ``gather`` round per destination rank, so a rank only ever
        holds what is addressed to it.  Each rank then shuffles its
        share with ``local_shuffle(seed + rank)``.  Without an
        initialized group of more than one process this is a plain
        local shuffle (which IS the global shuffle for one rank)."""
        import torch
        import torch.distributed as dist

        if not (dist.is_available() and dist.is_initialized()) \
                or dist.get_world_size() <= 1:
            self.local_shuffle(seed)
            return
        nranks = dist.get_world_size()
        rank = dist.get_rank()
        device = torch.device("cpu")
        if dist.get_backend() == "nccl":
            device = torch.device("cuda", torch.cuda.current_device())
        rng = np.random.RandomState(
            None if seed is None else seed + 7919 * rank)
        dest = rng.randint(0, nranks, size=self._n)

        bufs = [self._pack_instances(np.nonzero(dest == d)[0])
                for d in range(nranks)]
        sizes = torch.tensor([len(b) for b in bufs], dtype=torch.int64,
                             device=device)
        all_sizes = [torch.empty_like(sizes) for _ in range(nranks)]
        dist.all_gather(all_sizes, sizes)
        all_sizes = torch.stack(all_sizes).cpu().numpy()   # [src, dst]

        per_slot_vals = [[] for _ in self._slots]
        per_slot_lens = [[] for _ in self._slots]
        n_total = 0
        for d in range(nranks):
            maxlen = max(1, int(all_sizes[:, d].max()))
            padded = torch.zeros(maxlen, dtype=torch.uint8)
            if bufs[d]:
                padded[:len(bufs[d])] = torch.frombuffer(
                    bytearray(bufs[d]), dtype=torch.uint8)
            padded = padded.to(device)
            gathered = ([torch.empty_like(padded) for _ in range(nranks)]
                        if d == rank else None)
            dist.gather(padded, gathered, dst=d)
            if d != rank:
                continue
            for src in range(nranks):
                buf = gathered[src][:all_sizes[src, d]].cpu().numpy() \
                    .tobytes()
                cnt, slots = self._unpack_instances(buf)
                n_total += cnt
                for s, (vals, lens) in enumerate(slots):
                    per_slot_vals[s].append(vals)
                    per_slot_lens[s].append(lens)
        new_slots = []
        for s, (values, _) in enumerate(self._slots):
            vals = np.concatenate(per_slot_vals[s]) if per_slot_vals[s] \
                else values[:0]
            lens = np.concatenate(per_slot_lens[s]) if per_slot_lens[s] \
                else np.zeros(0, np.int64)
            offsets = np.zeros(n_total + 1, np.int64)
            offsets[1:] = np.cumsum(lens)
            new_slots.append((vals, offsets))
        self._slots = new_slots
        self._n = n_total
        self.local_shuffle(None if seed is None else seed + rank)

    def release_memory(self):
        self._slots = None
        self._n = 0

    def get_memory_data_size(self, fleet=None):
        return self._n

    def batches(self):
        if self._slots is None:
            raise RuntimeError("call load_into_memory() first")
        b = self.batch_size
        end = self._n - (self._n % b) if self.drop_last else self._n
        for start in range(0, end, b):
            yield self._instances_to_batch(
                self._slots, start, min(start + b, self._n))


class QueueDataset(DatasetBase):
    """Parity: fluid.QueueDataset — stream files without full load."""

    def batches(self):
        types = self._slot_types()
        for n, slots in self._parse_files(types):
            b = self.batch_size
            end = n - (n % b) if self.drop_last else n
            for start in range(0, end, b):
                yield self._instances_to_batch(
                    slots, start, min(start + b, n))
