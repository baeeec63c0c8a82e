"""Fleet data generators — the port of
``paddle_tpu/distributed/fleet/data_generator.py``, a copy (reference:
python/paddle/distributed/fleet/data_generator/data_generator.py).

User subclasses implement generate_sample(line) returning an iterator of
(slot_name, values) pairs; run_from_stdin/run_from_memory format them into
the MultiSlot text protocol consumed by the PS Dataset pipe command
(fleet/dataset.py)."""
from __future__ import annotations

import sys

__all__ = ["DataGenerator", "MultiSlotDataGenerator",
           "MultiSlotStringDataGenerator"]


class DataGenerator:
    def __init__(self):
        self._proto_info = None
        self.batch_size_ = 32

    def set_batch(self, batch_size):
        self.batch_size_ = batch_size

    def generate_sample(self, line):
        raise NotImplementedError(
            "subclasses return an iterator over [(slot, values), ...]")

    def generate_batch(self, samples):
        def local_iter():
            for s in samples:
                yield s

        return local_iter

    def _gen_str(self, line):
        raise NotImplementedError

    def run_from_stdin(self):
        for line in sys.stdin:
            line_iter = self.generate_sample(line)
            for user_parsed_line in line_iter():
                if user_parsed_line is None:
                    continue
                sys.stdout.write(self._gen_str(user_parsed_line))

    def run_from_memory(self):
        batch_samples = []
        for line in self.generate_sample(None)():
            if line is None:
                continue
            batch_samples.append(line)
            if len(batch_samples) == self.batch_size_:
                for pattern in self.generate_batch(batch_samples)():
                    sys.stdout.write(self._gen_str(pattern))
                batch_samples = []
        if batch_samples:
            for pattern in self.generate_batch(batch_samples)():
                sys.stdout.write(self._gen_str(pattern))


class MultiSlotDataGenerator(DataGenerator):
    """Lines look like: `slot_count id id ... slot2_count v v ...` —
    `name:count values` per slot, space-joined (reference _gen_str)."""

    def _gen_str(self, line):
        out = []
        for name, values in line:
            out.append(str(len(values)))
            out.extend(str(v) for v in values)
        return " ".join(out) + "\n"


class MultiSlotStringDataGenerator(DataGenerator):
    def _gen_str(self, line):
        out = []
        for name, values in line:
            out.append(str(len(values)))
            out.extend(str(v) for v in values)
        return " ".join(out) + "\n"
