"""Command-line interface: synth / datagen / train / index / serve (counterpart
of ``tpurec/cli.py``: the same subcommands, flags and printed lines).

    python -m tpurec_torch.cli synth --family tabular --out data/raw
    python -m tpurec_torch.cli datagen --family tabular --raw data/raw --out data/gen
    python -m tpurec_torch.cli train --config exp.json --data data/gen --workdir run1
    python -m tpurec_torch.cli index --export run1/export --data data/gen --out run1/index
    python -m tpurec_torch.cli serve --export run1/export --data data/gen --index run1/index --port 5000

Every step that runs a model (train, index, serve) runs on the CUDA card;
``TPUREC_PLATFORM=cpu`` runs it on the CPU instead. Unset, ``cuda`` or
``gpu`` mean the card, and asking for it where there is none raises: nothing
moves to the CPU on its own.
"""

from __future__ import annotations

import argparse
import json
import os


def platform_device() -> str:
    """The device ``TPUREC_PLATFORM`` names: 'cuda' (unset, 'cuda' or 'gpu')
    or 'cpu'; any other value raises."""
    value = os.environ.get("TPUREC_PLATFORM", "")
    if value in ("", "cuda", "gpu"):
        return "cuda"
    if value == "cpu":
        return "cpu"
    raise ValueError(f"TPUREC_PLATFORM={value!r}: expected 'cuda', 'gpu' or 'cpu'")


def cmd_datagen(args):
    from tpurec_torch.data import generators

    if args.family == "tabular":
        gen = generators.TabularDataGenerator(
            output_path=args.out,
            item_path=os.path.join(args.raw, "item_feature.dat"),
            user_path=os.path.join(args.raw, "user_feature.dat"),
            main_path=os.path.join(args.raw, "shop.dat"),
        )
    elif args.family == "impression":
        gen = generators.ImpressionLogGenerator(
            args.out, os.path.join(args.raw, "impression_log.jsonl")
        )
    elif args.family == "sequence":
        gen = generators.SequenceDataGenerator(
            args.out, os.path.join(args.raw, "events.jsonl"),
            max_seq_length=args.max_seq_length,
        )
    else:
        raise SystemExit(f"unknown family {args.family}")
    info = gen.run_all()
    print(f"wrote {args.out}: {info.total_dims} ids over {len(info.feature_names)} features")


def cmd_synth(args):
    from tpurec_torch.data import synthetic

    if args.family == "tabular":
        synthetic.make_ecommerce_raw(args.out, n_events=args.n_events, seed=args.seed)
    elif args.family == "impression":
        synthetic.make_impression_log_raw(args.out, n_events=args.n_events, seed=args.seed)
    elif args.family == "sequence":
        synthetic.make_behavior_sequence_raw(args.out, n_events=args.n_events, seed=args.seed)
    print(f"wrote synthetic raw data to {args.out}")


def cmd_train(args):
    from tpurec_torch.config import ExperimentConfig
    from tpurec_torch.data.loader import ArrayLoader, load_columnar, shard_paths
    from tpurec_torch.data.schema import DataInfo
    from tpurec_torch.train import Trainer

    device = platform_device()
    if args.config:
        with open(args.config) as f:
            cfg = ExperimentConfig.from_json(f.read())
    else:
        cfg = ExperimentConfig()
    if args.model:
        cfg = cfg.replace(model=cfg.model.replace(name=args.model))
    if args.workdir:
        cfg = cfg.replace(
            train=cfg.train.replace(
                checkpoint_dir=os.path.join(args.workdir, "checkpoint"),
                tensorboard_dir=os.path.join(args.workdir, "tensorboard"),
            )
        )
    info = DataInfo.load(args.data)
    train = load_columnar(shard_paths(args.data, "train"))
    test = load_columnar(shard_paths(args.data, "test"))
    trainer = Trainer(cfg, info, device=device)
    bs = cfg.train.batch_size
    state, report = trainer.run(
        lambda: iter(ArrayLoader(train, bs, seed=cfg.train.seed)),
        lambda: iter(ArrayLoader(test, bs, shuffle=False, pad_final=True)),
        restore=args.restore,
    )
    if args.workdir:
        trainer.export(state, os.path.join(args.workdir, "export"))
        with open(os.path.join(args.workdir, "report.json"), "w") as f:
            json.dump(report, f, indent=2, default=float)
    print("best eval:", report["best_eval"])


def _profiles(data_dir: str):
    with open(os.path.join(data_dir, "user_profile.json")) as f:
        user_profile = json.load(f)
    with open(os.path.join(data_dir, "item_profile.json")) as f:
        item_profile = json.load(f)
    return user_profile, item_profile


def cmd_index(args):
    from tpurec_torch.data.schema import DataInfo
    from tpurec_torch.serving import DictKVStore, OfflineIndexer
    from tpurec_torch.serving.export import load_servable

    device = platform_device()
    info = DataInfo.load(args.data)
    servable = load_servable(args.export, info, device=device)
    if servable.user_tower is None:
        raise SystemExit("exported model has no towers; index needs a two-tower model")
    user_profile, item_profile = _profiles(args.data)
    kv = DictKVStore(os.path.join(args.out, "kv_store.json"))
    indexer = OfflineIndexer(
        servable.user_tower, servable.item_tower, user_profile, item_profile,
        info.user_features, info.item_features, device=device,
    )
    result = indexer.run(args.out, kv_store=kv, topk=args.topk)
    kv.save()
    print(f"indexed {result['num_users']} users x {result['num_items']} items → {args.out}")


def build_server(args):
    """The HTTP server ``serve`` runs, not yet serving: ``serve_forever`` it
    (or on a thread, then ``shutdown`` and ``server_close``)."""
    import numpy as np

    from tpurec_torch.data.schema import DataInfo
    from tpurec_torch.serving.export import load_servable
    from tpurec_torch.serving.kvstore import DictKVStore
    from tpurec_torch.serving.server import RecommendService, make_server

    device = platform_device()
    info = DataInfo.load(args.data)
    servable = load_servable(args.export, info, device=device)
    user_profile, item_profile = _profiles(args.data)
    kv = DictKVStore(os.path.join(args.index, "kv_store.json")) if args.index else None
    item_ids, item_emb = [], None
    if args.index:
        with np.load(os.path.join(args.index, "topk_index.npz"), allow_pickle=False) as idx:
            item_ids = [str(x) for x in idx["item_ids"]]
            item_emb = idx["item_embeddings"]
    service = RecommendService(
        user_tower=servable.user_tower,
        ranker=servable.rank,
        user_profile=user_profile,
        item_profile=item_profile,
        user_feature_names=info.user_features,
        item_feature_names=info.item_features,
        kv_store=kv,
        item_ids=item_ids,
        item_embeddings=item_emb,
        device=device,
    )
    return make_server(service, args.host, args.port)


def cmd_serve(args):
    server = build_server(args)
    print(f"serving on http://{args.host}:{server.server_address[1]}/predict", flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="tpurec_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("datagen", help="raw files → TFRecords + metadata")
    d.add_argument("--family", choices=["tabular", "impression", "sequence"], required=True)
    d.add_argument("--raw", required=True)
    d.add_argument("--out", required=True)
    d.add_argument("--max-seq-length", type=int, default=30, dest="max_seq_length")
    d.set_defaults(fn=cmd_datagen)

    s = sub.add_parser("synth", help="generate synthetic raw data")
    s.add_argument("--family", choices=["tabular", "impression", "sequence"], required=True)
    s.add_argument("--out", required=True)
    s.add_argument("--n-events", type=int, default=100_000, dest="n_events")
    s.add_argument("--seed", type=int, default=0)
    s.set_defaults(fn=cmd_synth)

    t = sub.add_parser("train", help="train a model on generated data")
    t.add_argument("--config", help="ExperimentConfig JSON file")
    t.add_argument("--model", help="registry name override")
    t.add_argument("--data", required=True)
    t.add_argument("--workdir", default="")
    t.add_argument("--restore", action="store_true")
    t.set_defaults(fn=cmd_train)

    i = sub.add_parser("index", help="offline retrieval indexing")
    i.add_argument("--export", required=True)
    i.add_argument("--data", required=True)
    i.add_argument("--out", required=True)
    i.add_argument("--topk", type=int, default=20)
    i.set_defaults(fn=cmd_index)

    v = sub.add_parser("serve", help="online HTTP serving")
    v.add_argument("--export", required=True)
    v.add_argument("--data", required=True)
    v.add_argument("--index", default="")
    v.add_argument("--host", default="127.0.0.1")
    v.add_argument("--port", type=int, default=5000)
    v.set_defaults(fn=cmd_serve)

    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
