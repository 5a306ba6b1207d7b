"""LAF303 bad twin: a library loaded and its launcher called outside the
kernel wrappers."""
from repro_torch.kernels import _build


def count_rows(words, out, stream):
    lib = _build.load("popcount")
    return lib.row_popcount_launch(words.data_ptr(), words.shape[0], words.shape[1], None, None,
                                   out.data_ptr(), stream)
