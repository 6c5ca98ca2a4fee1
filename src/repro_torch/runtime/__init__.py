"""Runtime (port of ``repro/runtime``): the microbatch scheduler
(``runtime.scheduler``), the closed-loop mission simulator
(``runtime.mission``) and the multi-UAV fleet (``runtime.fleet``).

Import them from their modules: the engine imports ``runtime.scheduler``,
and the mission runtime imports the engine, so this package re-exports
nothing.
"""
