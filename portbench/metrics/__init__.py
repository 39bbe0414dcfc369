"""One reader a metric, named as the metric: ``read(run)`` gives its value
from the run's window, set-up or trace, or None where it finds nothing to
read (a per-layer metric is then left out of the line)."""
