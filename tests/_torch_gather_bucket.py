"""One bucket of the gather path's layout, made from a seed, for the tests
of the gather-Gramian kernel and its plain version (jax-free, so the GPU
tests can use it too).  Test files import it as ``_torch_gather_bucket``:
pytest puts this directory on the path.
"""
import numpy as np
import torch

# the bucket ladder of the Netflix configuration
# (benchmark/configs/netflix.json, options.bucket_widths)
NETFLIX_LADDER = (8, 12, 16, 20, 24, 28, 32, 40, 48, 56, 64, 80, 96, 112,
                  128, 160, 192, 224, 256, 320, 384, 512, 768, 1024, 2048)


def gather_bucket(W, K, arity, rows, seed, n_tables=(300, 700)):
    """(partner tables [n_d, K] float32, parts [rows, W] int32, val, mask
    [rows, W] float32) as the layout fills a bucket of width W: the first
    rows full (the pieces of chunked instances), then rows filled to a
    random length with mask 0, value 0 and index 0 after it (an
    instance's last piece), then 3 padding rows of zeros (``row_pad``)."""
    rng = np.random.default_rng(seed)
    tables = [torch.from_numpy(rng.standard_normal((n_tables[d], K))
                               .astype(np.float32))
              for d in range(arity - 1)]
    fill = rng.integers(1, W + 1, rows)
    fill[:max(1, rows // 5)] = W
    fill[-3:] = 0
    mask = (np.arange(W)[None, :] < fill[:, None]).astype(np.float32)
    parts = [torch.from_numpy((rng.integers(0, n_tables[d], (rows, W))
                               * mask).astype(np.int32))
             for d in range(arity - 1)]
    val = torch.from_numpy((rng.standard_normal((rows, W)) * mask)
                           .astype(np.float32))
    return tables, parts, val, torch.from_numpy(mask)
