"""Images completed in the window (whole batches, each ended by the copy
of its images to the host) over the window's wall seconds."""


def read(run):
    v = run.values
    if v.get('kind') != 'sample':
        return None
    return v['images'] / v['window_s']
