"""The (dp, fsdp, tp, sp) mesh over this job's ranks (`parallel.mesh`)."""
