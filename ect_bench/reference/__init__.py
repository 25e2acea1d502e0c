"""The plain reference the benchmark holds the port's answers against:
FSE tables, normalization and headers (``fse``), the per-lane and
shared-stream coders (``coder``) and the ``FSET`` container (``frame``), in
plain Python and NumPy. It imports neither JAX nor anything of the
program it judges, and takes nothing the program made but the answers it
judges."""

from .frame import Knobs, Report, check_frame, parse

__all__ = ["Knobs", "Report", "check_frame", "parse"]
