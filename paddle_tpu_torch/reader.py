"""Reader decorators of the port (counterpart of paddle_tpu/reader.py;
reference python/paddle/reader/decorator.py and python/paddle/batch.py):
old-style input pipelines, where a reader is a function that returns an
iterator of samples. Stdlib only, as the JAX package's.

``shuffle`` draws from Python's global ``random`` generator, as there, so
the same ``random.seed`` gives both packages the same order. ``buffered``
runs the reader in a producer thread up to ``size`` items ahead;
``batch`` groups a reader's samples into lists of ``batch_size``.
"""
from __future__ import annotations

import queue as _queue
import random as _random
import threading as _threading


def shuffle(reader, buf_size):
    def reader_():
        buf = []
        for item in reader():
            buf.append(item)
            if len(buf) >= buf_size:
                _random.shuffle(buf)
                yield from buf
                buf = []
        if buf:
            _random.shuffle(buf)
            yield from buf

    return reader_


def buffered(reader, size):
    """Decorate `reader` with a bounded background buffer of `size` items.

    Reference semantics (python/paddle/reader/decorator.py buffered): a
    producer thread runs the underlying reader up to `size` items ahead so
    the consumer only pays residual wait. Producer exceptions re-raise at the
    consumer; closing the returned generator stops the producer thread."""
    _DONE = object()

    def reader_():
        q = _queue.Queue(maxsize=max(1, int(size)))
        stop = _threading.Event()

        def put(item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except _queue.Full:
                    continue
            return False

        def produce():
            try:
                for item in reader():
                    if not put(item):
                        return
            except BaseException as e:  # re-raised at the consumer
                put(("__error__", e))
                return
            put(_DONE)

        t = _threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                try:
                    item = q.get(timeout=0.1)
                except _queue.Empty:
                    if not t.is_alive() and q.empty():
                        raise RuntimeError("the buffered reader's producer ended "
                                           "without a word")
                    continue
                if item is _DONE:
                    return
                if isinstance(item, tuple) and len(item) == 2 \
                        and item[0] == "__error__":
                    raise item[1]
                yield item
        finally:
            stop.set()
            while True:  # unblock a producer stuck on a full queue
                try:
                    q.get_nowait()
                except _queue.Empty:
                    break
            t.join(timeout=1.0)

    return reader_


def chain(*readers):
    def reader_():
        for r in readers:
            yield from r()

    return reader_


class ComposeNotAligned(ValueError):
    pass


def compose(*readers, check_alignment=True):
    def reader_():
        iters = [iter(r()) for r in readers]
        while True:
            items = []
            stopped = 0
            for it in iters:
                try:
                    items.append(next(it))
                except StopIteration:
                    stopped += 1
            if stopped:
                if check_alignment and stopped != len(iters):
                    raise ComposeNotAligned(
                        "composed readers have different lengths")
                return
            out = []
            for item in items:
                out.extend(item if isinstance(item, tuple) else (item,))
            yield tuple(out)

    return reader_


def firstn(reader, n):
    def reader_():
        for i, item in enumerate(reader()):
            if i >= n:
                break
            yield item

    return reader_


def map_readers(func, *readers):
    def reader_():
        for items in zip(*[r() for r in readers]):
            yield func(*items)

    return reader_



def batch(reader, batch_size, drop_last=False):
    """A reader of lists of ``batch_size`` samples of ``reader`` (the last
    one shorter unless ``drop_last``)."""

    def batch_reader():
        b = []
        for item in reader():
            b.append(item)
            if len(b) == batch_size:
                yield b
                b = []
        if b and not drop_last:
            yield b

    return batch_reader
