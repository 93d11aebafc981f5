'''Training of the bi-modal captioner and proposal generator: losses,
optimizers, steps, epoch loops and validation (counterpart of
``bmt_tpu.train``). The trainers, ``train.cap_trainer.train_cap`` and
``train.prop_trainer.train_prop``, are imported from their modules.'''
from bmt_tpu_torch.train.loops import (make_decode_fn, make_strategy_fn,
                                       train_epoch_cap, train_epoch_prop,
                                       validate_next_word, validate_prop,
                                       validation_1by1)
from bmt_tpu_torch.train.losses import (caption_loss, label_smoothing_kl,
                                        label_smoothing_kl_logits)
from bmt_tpu_torch.train.optim import (Optimizer, ReduceLROnPlateau,
                                       build_optimizer, get_learning_rate,
                                       set_learning_rate)
from bmt_tpu_torch.train.steps import (TrainState, TrainStep,
                                       init_train_state,
                                       make_cap_train_step,
                                       make_cap_val_step, make_multistep,
                                       make_prop_inference_step,
                                       make_prop_train_step, prop_frozen)
