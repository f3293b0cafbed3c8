"""Acceleration accounting: one [generated, steps, compression] record a
result, an aggregate summary, and a JSON round trip.

The records are those of the JAX package's ``DecodeLog``, and the JSON of
one loads in the other. An engine built with ``log=DecodeLog()`` appends
every result it returns.
"""

from __future__ import annotations

import json
from typing import List, Optional


class DecodeLog:
    def __init__(self, debug: bool = False):
        self.records: List[list] = []   # [generated, steps, ratio]
        self.debug = debug              # print a report a result

    def append(self, result) -> None:
        gen, steps = result.num_generated, result.steps
        self.records.append([gen, steps, round(gen / max(steps, 1), 2)])
        if self.debug:
            print(
                "\n==========================ACCELERATION===REPORT======================================\n"
                f"Generated tokens: {gen} Total steps: {steps} "
                f"Compression ratio: {round(gen / max(steps, 1), 2)}\n"
                "======================================================================================")

    def log_history(self, clear: bool = False) -> Optional[str]:
        """The summary over every record (None when there is none)."""
        if not self.records:
            return None
        gen = sum(r[0] for r in self.records)
        steps = sum(r[1] for r in self.records)
        msg = (
            "\n==========================ACCELERATION===SUMMARY======================================\n"
            f"Generated tokens: {gen} Total steps: {steps} "
            f"Compression ratio: {round(gen / max(steps, 1), 2)}\n"
            "======================================================================================"
        )
        if clear:
            self.records.clear()
        return msg

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.records, f)

    @classmethod
    def load(cls, path: str) -> "DecodeLog":
        log = cls()
        with open(path) as f:
            log.records = json.load(f)
        return log
