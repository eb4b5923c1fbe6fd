"""Runners of traffic mixes: `traffic/<mix>.json` names its runner, a module
here with `run(record.Run)`: set-up, the measured window, and the check
against the reference."""
