"""The (dp, fsdp, tp, sp) mesh over this job's ranks (`parallel.mesh`) and the
partition rules that give each rank its slice of the weights
(`parallel.partition`)."""
