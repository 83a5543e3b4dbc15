"""``python -m aaclip_tpu_torch.train``: the two-stage training CLI
(``train/cli.py``)."""

from aaclip_tpu_torch.train.cli import main

if __name__ == "__main__":
    main()
