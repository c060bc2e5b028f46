from wormhole_tpu_torch.solver.progress import Progress  # noqa: F401
from wormhole_tpu_torch.solver.minibatch_solver import MinibatchSolver  # noqa: F401
