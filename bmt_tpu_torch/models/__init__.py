'''The captioning models and the proposal generators, bi-modal and
uni-modal.'''
from bmt_tpu_torch.models.captioning import (BiModalTransformer, CapModelDims,
                                             UniModalTransformer,
                                             captioner_class)
from bmt_tpu_torch.models.proposal import (MultimodalProposalGenerator,
                                           PropModelDims,
                                           UnimodalProposalGenerator,
                                           proposal_class)

__all__ = ['BiModalTransformer', 'CapModelDims',
           'MultimodalProposalGenerator', 'PropModelDims',
           'UniModalTransformer', 'UnimodalProposalGenerator',
           'captioner_class', 'proposal_class']
