"""Refusal of the JAX training mains' flags that the port does not take
yet, each with the ROADMAP item that brings it."""

from __future__ import annotations

#: the JAX mains' short options, by their long name
_SHORT = {"-f": "--folder"}


def refuse_unported(argv, unported: dict) -> None:
    """Exit naming the ROADMAP item of the first flag of ``argv`` that is a
    key of ``unported`` (``{flag: item}``; a key may be ``"--flag=value"``
    to refuse one value only)."""
    for i, arg in enumerate(argv):
        flag, _, value = arg.partition("=")
        flag = _SHORT.get(flag, flag)
        if not value and i + 1 < len(argv) and not argv[i + 1].startswith(
                "-"):
            value = argv[i + 1]
        for key in (flag, f"{flag}={value}"):
            if key in unported:
                raise SystemExit(f"{key} is not supported by the PyTorch "
                                 f"port yet: ROADMAP {unported[key]}")
