"""The training slice: schedules, precision, AdamW param groups, the train
step, the host data path, the CLI flags and the ``main`` orchestrator."""
