"""The benchmark's span around a step's or batch's draw and its copy to the
card (the program's ``data.pipeline.shard_batch``), averaged over the
measured window, in ms."""


def read(run):
    d = run.window["data_s"]
    return 1e3 * sum(d) / len(d) if d else None
