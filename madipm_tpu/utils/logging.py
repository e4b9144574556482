"""Logger and profiling hooks.

Analogue of the MadNLPLogger machinery the reference routes all output
through (reference: src/utils.jl:131-137 builds the logger from
``print_level`` / ``file_print_level`` / ``output_file``;
src/structure.jl:180-197 prints the iteration table through it), plus the
device profiling hook the reference lacks (SURVEY §5: the reference has
wall-clock counters only; the useful trace is an XLA profiler capture
viewable in TensorBoard/Perfetto).
"""

from __future__ import annotations

import contextlib
import sys
from typing import Optional, TextIO

from .options import PrintLevel


class Logger:
    """Leveled console + optional file sink logger.

    ``print_level`` gates the console, ``file_print_level`` the file sink —
    the same two-channel design as MadNLPLogger (reference:
    src/utils.jl:131-137).
    """

    def __init__(
        self,
        print_level: PrintLevel = PrintLevel.INFO,
        file_print_level: PrintLevel = PrintLevel.INFO,
        output_file: str = "",
        stream: TextIO = None,
    ):
        self.print_level = print_level
        self.file_print_level = file_print_level
        self.stream = stream if stream is not None else sys.stdout
        self._file: Optional[TextIO] = None
        if output_file:
            self._file = open(output_file, "a")

    def close(self):
        if self._file is not None:
            self._file.close()
            self._file = None

    def __del__(self):  # best-effort flush of the file sink
        try:
            self.close()
        except Exception:
            pass

    def log(self, level: PrintLevel, msg: str):
        if level >= self.print_level:
            print(msg, file=self.stream, flush=True)
        if self._file is not None and level >= self.file_print_level:
            self._file.write(msg + "\n")
            self._file.flush()

    def trace(self, msg: str):
        self.log(PrintLevel.TRACE, msg)

    def debug(self, msg: str):
        self.log(PrintLevel.DEBUG, msg)

    def info(self, msg: str):
        self.log(PrintLevel.INFO, msg)

    def notice(self, msg: str):
        self.log(PrintLevel.NOTICE, msg)

    def warn(self, msg: str):
        self.log(PrintLevel.WARN, msg)

    def error(self, msg: str):
        self.log(PrintLevel.ERROR, msg)


@contextlib.contextmanager
def profile_trace(trace_dir: Optional[str]):
    """Optionally capture an XLA profiler trace around a solve.

    ``with profile_trace("/tmp/madipm_trace"): solver.solve()`` writes a
    TensorBoard/Perfetto-compatible trace of every XLA op (compile,
    host-device transfers, kernel times).  No-op when ``trace_dir`` is falsy.  This is
    the per-phase visibility the reference approximates with wall-clock
    counters (reference: src/structure.jl:86,155, src/solver.jl:368,407).
    """
    if not trace_dir:
        yield
        return
    import jax

    with jax.profiler.trace(trace_dir):
        yield
