'''Caption decoding: greedy, beam search and sampling, for the bi-modal and
the uni-modal captioners.'''
from bmt_tpu_torch.decode.beam import (beam_search_bimodal,
                                       beam_search_unimodal,
                                       make_bimodal_beam_fn)
from bmt_tpu_torch.decode.greedy import (greedy_decode_bimodal,
                                         greedy_decode_uncached,
                                         greedy_decode_unimodal,
                                         make_bimodal_greedy_fn)
from bmt_tpu_torch.decode.sample import (filter_logits,
                                         make_bimodal_sample_fn,
                                         sample_decode_bimodal,
                                         sample_decode_unimodal)

__all__ = ['beam_search_bimodal', 'beam_search_unimodal', 'filter_logits',
           'greedy_decode_bimodal', 'greedy_decode_uncached',
           'greedy_decode_unimodal', 'make_bimodal_beam_fn',
           'make_bimodal_greedy_fn', 'make_bimodal_sample_fn',
           'sample_decode_bimodal',
           'sample_decode_unimodal']
