"""``python -m unirec_tpu_torch <command>`` dispatcher.

Commands:
  data          data-pipeline builders (dicts, filtering, rec samples)
  train         training stages (precompute/mwne/item-qformer/user-qformer/
                joint), evaluate, and export-pth / export-pretrained
  tokens        batch item-query-token generation (flagship data tool)
  embed         candidate-pool item embeddings (clip / qwen3)
  review-embed  review + item concatenated embeddings
  users         offline bulk user-embedding sweep (joint-space vectors)
  serve         HTTP recommendation server (full-catalog retrieval)

Each command takes its CLI's flags (``<command> --help``).  Model work runs
on the CUDA card unless ``--device cpu`` is given.
"""

import sys


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd == "data":
        from unirec_tpu_torch.cli.data_pipeline import main as m
    elif cmd == "train":
        from unirec_tpu_torch.cli.train_cli import main as m
    elif cmd == "tokens":
        from unirec_tpu_torch.cli.generate_all_item_embeddings import main as m
    elif cmd == "embed":
        from unirec_tpu_torch.cli.candidate_embeddings import main as m
    elif cmd == "review-embed":
        from unirec_tpu_torch.cli.review_embeddings import main as m
    elif cmd == "users":
        from unirec_tpu_torch.cli.user_embeddings import main as m
    elif cmd == "serve":
        from unirec_tpu_torch.cli.serve_cli import main as m
    else:
        print(f"unknown command {cmd!r}\n{__doc__}", file=sys.stderr)
        return 2
    return m(rest)


if __name__ == "__main__":
    raise SystemExit(main())
