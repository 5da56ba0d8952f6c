from repro_torch.runtime.straggler import StepMonitor
from repro_torch.runtime.elastic import plan_mesh, reshard
from repro_torch.runtime.recovery import RecoveryPolicy, run_resilient_loop
