"""Tools of the port: cloud viewers and players (pcview, pcman, pcplayer),
the ATE A/B harness (ab_ate), profiling (profile_trace, nn_min_sweep) and
the registration-step entry point (entry)."""
