"""``python -m dmlc_core_tpu_torch.tracker.dmlc_submit``: the dmlc-submit
CLI of the port."""
from .submit import main

if __name__ == "__main__":
    main()
