#!/usr/bin/env python
"""Event-stream consumer that feeds detected-object crops to the image
ensemble — the "device hub" integration shape: a message bus delivers
{device_id, image_b64} events, each is classified, and positives are
reported.

Parity: the fork-added ref:src/python/examples/device_hub.py:119-166
(Kafka consumer feeding base64 crops to inference; e-bike-in-elevator
use case). The Kafka dependency is optional here: with --kafka the
consumer attaches to a broker (requires kafka-python, not bundled in
this image); without it, events are read as JSON lines from stdin or a
file so the pipeline runs anywhere.

The port's copy of ``examples/device_hub.py``,
on the port's client. Run it as
``python -m client_tpu_torch.examples.device_hub``.
"""

import argparse
import json
import sys

from client_tpu_torch.examples.base64_image_client import infer


def iter_events_stdin(path):
    stream = open(path) if path else sys.stdin
    for line in stream:
        line = line.strip()
        if line:
            yield json.loads(line)


def iter_events_kafka(bootstrap, topic, group):
    try:
        from kafka import KafkaConsumer  # noqa: PLC0415
    except ImportError:
        sys.exit("error: --kafka requires kafka-python (pip install "
                 "kafka-python); use stdin/file mode here")
    consumer = KafkaConsumer(topic, bootstrap_servers=bootstrap,
                             group_id=group,
                             value_deserializer=lambda b: json.loads(b))
    for msg in consumer:
        yield msg.value


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-u", "--url", default="localhost:8000")
    ap.add_argument("-m", "--model", default="preprocess_resnet50")
    ap.add_argument("--kafka", default=None,
                    help="bootstrap servers (enables Kafka mode)")
    ap.add_argument("--topic", default="detected_objects")
    ap.add_argument("--group", default="device_hub")
    ap.add_argument("--events", default=None,
                    help="JSON-lines file of {device_id, image_b64} "
                         "events (default: stdin)")
    ap.add_argument("--watch-class", type=int, default=None,
                    help="report only events whose top-1 class matches")
    args = ap.parse_args(argv)

    events = (iter_events_kafka(args.kafka, args.topic, args.group)
              if args.kafka else iter_events_stdin(args.events))

    from client_tpu_torch.client import http as httpclient

    client = httpclient.InferenceServerClient(args.url)
    try:
        for event in events:
            device = event.get("device_id", "?")
            image_b64 = event["image_b64"].encode() \
                if isinstance(event["image_b64"], str) \
                else event["image_b64"]
            results = infer(image_b64, model_name=args.model,
                            client=client)
            top_class, top_score = results[0]
            if args.watch_class is None or top_class == args.watch_class:
                print(json.dumps({"device_id": device,
                                  "class": top_class,
                                  "score": round(top_score, 4)}),
                      flush=True)
    finally:
        client.close()


if __name__ == "__main__":
    main()
