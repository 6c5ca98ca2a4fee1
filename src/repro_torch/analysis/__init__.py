"""Runtime analysis of the port (port of ``repro/analysis``).

Only the runtime half is ported: ``analysis.sanitizers`` holds the
recompile census and the transfer guard behind ``AveryEngine``'s
``debug_recompiles`` / ``debug_transfers`` knobs, and the census the stage
profiler's compile observatory diffs. The reference's static half
(``averylint``, ``python -m repro.analysis.lint src/``) already lints every
file under ``src/``, the port included, so it has no port.
"""
