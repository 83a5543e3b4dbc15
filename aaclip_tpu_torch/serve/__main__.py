"""``python -m aaclip_tpu_torch.serve``: the HTTP inference server on the
card (``serve/server.py::main``; ``--help`` lists the flags)."""

from aaclip_tpu_torch.serve.server import main

if __name__ == "__main__":
    main()
