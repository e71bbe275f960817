"""Training: the train state, the train step and the Trainer."""

from fit_tpu_torch._exports import lazy_exports

__all__, __getattr__, __dir__ = lazy_exports(
    __name__,
    {
        ".loop": (
            "Trainer",
        ),
        ".state": (
            "TrainState",
            "create_train_state",
            "ema_update",
            "make_optimizer",
        ),
        ".step": (
            "diffusion_loss",
            "make_eval_step",
            "make_train_step",
            "split_for_accumulation",
        ),
    },
)
