"""ANSI console coloring (equivalent of reference source/console.c).

The reference supports Win32 console APIs and ANSI escapes; this framework
targets POSIX terminals only and degrades to no-ops when stdout is not a TTY.
"""

from __future__ import annotations

import sys

_COLORS = {
    "black": 0,
    "red": 1,
    "green": 2,
    "yellow": 3,
    "blue": 4,
    "magenta": 5,
    "cyan": 6,
    "white": 7,
}


def _enabled(file) -> bool:
    try:
        return file.isatty()
    except Exception:
        return False


def colored(text: str, fg: str = "white", bg: str | None = None,
            bright: bool = True, file=None) -> str:
    file = file or sys.stdout
    if not _enabled(file):
        return text
    codes = []
    if bright:
        codes.append("1")
    codes.append(str(30 + _COLORS.get(fg, 7)))
    if bg is not None:
        codes.append(str(40 + _COLORS.get(bg, 0)))
    return f"\x1b[{';'.join(codes)}m{text}\x1b[0m"


def banner(text: str, file=None) -> str:
    return colored(text, fg="red", bg="white", bright=True, file=file)
