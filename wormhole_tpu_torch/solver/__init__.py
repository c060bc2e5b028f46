from wormhole_tpu_torch.solver.progress import Progress  # noqa: F401


def __getattr__(name):
    # MinibatchSolver imports torch: loaded on first use, so the roles
    # that only need the pool (the scheduler) stay free of it
    if name == "MinibatchSolver":
        from wormhole_tpu_torch.solver.minibatch_solver import MinibatchSolver

        return MinibatchSolver
    raise AttributeError(name)
