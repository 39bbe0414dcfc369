"""Eva's physical mode (``repro/cluster/localcloud.py``): ``localcloud``
runs rounds of ``EvaScheduler`` over real training jobs.  The simulator,
its traces and the fleet generator wait for the port's fleet-scale planner,
so this package imports none of them."""
