"""serve.batch_size: queries a Dataset.search call of the window carried
(the BatchingSearcher's coalescing), the mean over the window's calls."""


def read(run):
    return sum(b for _, _, b in run.calls) / len(run.calls) if run.calls else None
