"""repro-lint of the port: stdlib-ast static analysis for this repo's
invariants (port of ``repro.analysis``; it also checks the port's own
wire planes).

Entry points: :func:`run_analysis` (library) and
``python -m repro_torch.launch.lint`` (CLI).  See ``core.py`` for the
rule family overview and the suppression-comment syntax.
"""

from .core import (AnalysisResult, Finding, SourceFile, collect_files,
                   load_file, run_analysis)

__all__ = ["AnalysisResult", "Finding", "SourceFile", "collect_files",
           "load_file", "run_analysis"]
