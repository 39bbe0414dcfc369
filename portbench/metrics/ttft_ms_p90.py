"""The 90th percentile (nearest rank) over every request of the window of
the time from when its batch was due to when its first token was on the
host, in ms."""
import math


def read(run):
    lat = run.window.get("latencies_s")
    if not lat:
        return None
    lat = sorted(lat)
    return 1e3 * lat[math.ceil(0.9 * len(lat)) - 1]
