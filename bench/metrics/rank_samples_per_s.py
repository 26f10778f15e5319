"""rank_samples_per_s: every sample scored in the window over the window's
seconds on the host's clock."""


def read(run):
    return sum(r["items"] for r in run.records) / run.window_s
