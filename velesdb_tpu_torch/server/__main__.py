"""``python -m velesdb_tpu_torch.server <data_dir> [--host H] [--port P]
[--device cuda|cpu]``: the REST server on the card (the default) or, with
``--device cpu``, on the CPU."""

import argparse

from velesdb_tpu_torch.server.app import serve


def main() -> None:
    p = argparse.ArgumentParser(prog="velesdb_tpu_torch.server")
    p.add_argument("data_dir", help="database directory")
    p.add_argument("--host", default=None)
    p.add_argument("--port", type=int, default=None)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args()
    serve(args.data_dir, args.host, args.port, device=args.device)


if __name__ == "__main__":
    main()
