"""triton_dist_tpu_torch.faults — the port's counterpart of
triton_dist_tpu.faults. Only two errors are ported: the one a wire
image's consume edge raises (errors.WireIntegrityError) and the one the
resident serving loop's watchdog raises (errors.DeadlineExceeded); the
guard builds, fault plans and the degradation ladder are ROADMAP item
8."""
