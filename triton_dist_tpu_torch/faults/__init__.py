"""triton_dist_tpu_torch.faults — the port's counterpart of
triton_dist_tpu.faults. Only the error a wire image's consume edge
raises is ported (errors.WireIntegrityError); the guard builds, fault
plans and the degradation ladder are ROADMAP item 8."""
