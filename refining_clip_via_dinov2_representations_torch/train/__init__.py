"""The training slice: schedules, precision, the param-group optimizers, the train
step, the host data path, evaluation, checkpoints, the CLI flags and the
``main`` orchestrator."""
