/* vfgsio -- native pipelined frame I/O for the grain engine.
 *
 * The reference model does synchronous row-wise stdio per frame
 * (yuv.c:162-214), which serializes disk I/O with compute.  The device engine
 * grains thousands of 4K frames/s with frames resident (PERF.md), so feeding
 * the device is the bottleneck, and this library provides:
 *
 *   - a reader with a background pthread that prefetches whole frames into a
 *     ring of page-aligned buffers (read-ahead hides disk latency), and
 *   - a writer with a background pthread draining a ring, so the frame loop
 *     never blocks on write(2).
 *
 * Plain C99 + pthreads; exposed through ctypes (utils/native_io.py) with a
 * numpy fallback when the shared library is unavailable.
 */

#define _GNU_SOURCE
#include <pthread.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <unistd.h>
#include <fcntl.h>
#include <sys/types.h>

typedef struct {
    int      fd;
    size_t   frame_bytes;
    int      nbuf;
    uint8_t **buf;
    ssize_t *fill;       /* bytes valid in slot; -1 = empty */
    int      head, tail; /* producer writes head, consumer reads tail */
    int      count;
    int      eof;
    int      stop;
    pthread_t thread;
    pthread_mutex_t mu;
    pthread_cond_t  can_put, can_get;
} vfgsio_ring;

static void *reader_main(void *arg)
{
    vfgsio_ring *r = arg;
    for (;;) {
        pthread_mutex_lock(&r->mu);
        while (r->count == r->nbuf && !r->stop)
            pthread_cond_wait(&r->can_put, &r->mu);
        if (r->stop) { pthread_mutex_unlock(&r->mu); return NULL; }
        int slot = r->head;
        pthread_mutex_unlock(&r->mu);

        size_t got = 0;
        while (got < r->frame_bytes) {
            ssize_t n = read(r->fd, r->buf[slot] + got, r->frame_bytes - got);
            if (n <= 0) break;
            got += (size_t)n;
        }

        pthread_mutex_lock(&r->mu);
        r->fill[slot] = (got == r->frame_bytes) ? (ssize_t)got : (ssize_t)-1;
        if (got == r->frame_bytes) {
            r->head = (r->head + 1) % r->nbuf;
            r->count++;
        } else {
            r->eof = 1;
        }
        pthread_cond_signal(&r->can_get);
        int done = r->eof;
        pthread_mutex_unlock(&r->mu);
        if (done) return NULL;
    }
}

static void *writer_main(void *arg)
{
    vfgsio_ring *r = arg;
    for (;;) {
        pthread_mutex_lock(&r->mu);
        while (r->count == 0 && !r->stop)
            pthread_cond_wait(&r->can_get, &r->mu);
        if (r->count == 0 && r->stop) { pthread_mutex_unlock(&r->mu); return NULL; }
        int slot = r->tail;
        size_t len = (size_t)r->fill[slot];
        pthread_mutex_unlock(&r->mu);

        size_t put = 0;
        while (put < len) {
            ssize_t n = write(r->fd, r->buf[slot] + put, len - put);
            if (n <= 0) { r->eof = 1; break; } /* write error */
            put += (size_t)n;
        }

        pthread_mutex_lock(&r->mu);
        r->tail = (r->tail + 1) % r->nbuf;
        r->count--;
        pthread_cond_signal(&r->can_put);
        pthread_mutex_unlock(&r->mu);
    }
}

static vfgsio_ring *ring_new(int fd, size_t frame_bytes, int nbuf)
{
    vfgsio_ring *r = calloc(1, sizeof(*r));
    if (!r) return NULL;
    r->fd = fd;
    r->frame_bytes = frame_bytes;
    r->nbuf = nbuf;
    r->buf = calloc(nbuf, sizeof(uint8_t *));
    r->fill = calloc(nbuf, sizeof(ssize_t));
    for (int i = 0; i < nbuf; i++) {
        if (posix_memalign((void **)&r->buf[i], 4096, frame_bytes)) return NULL;
        r->fill[i] = -1;
    }
    pthread_mutex_init(&r->mu, NULL);
    pthread_cond_init(&r->can_put, NULL);
    pthread_cond_init(&r->can_get, NULL);
    return r;
}

/* ---- reader API ---- */

void *vfgsio_reader_open(const char *path, size_t frame_bytes, int nbuf,
                         long seek_frames)
{
    int fd = open(path, O_RDONLY);
    if (fd < 0) return NULL;
    if (seek_frames > 0)
        lseek(fd, (off_t)frame_bytes * seek_frames, SEEK_SET);
    vfgsio_ring *r = ring_new(fd, frame_bytes, nbuf);
    if (!r) { close(fd); return NULL; }
    pthread_create(&r->thread, NULL, reader_main, r);
    return r;
}

/* Copy the next frame into dst.  Returns 1 on success, 0 at EOF. */
int vfgsio_reader_next(void *h, uint8_t *dst)
{
    vfgsio_ring *r = h;
    pthread_mutex_lock(&r->mu);
    while (r->count == 0 && !r->eof)
        pthread_cond_wait(&r->can_get, &r->mu);
    if (r->count == 0) { pthread_mutex_unlock(&r->mu); return 0; }
    int slot = r->tail;
    pthread_mutex_unlock(&r->mu);

    memcpy(dst, r->buf[slot], r->frame_bytes);

    pthread_mutex_lock(&r->mu);
    r->tail = (r->tail + 1) % r->nbuf;
    r->count--;
    pthread_cond_signal(&r->can_put);
    pthread_mutex_unlock(&r->mu);
    return 1;
}

/* ---- writer API ---- */

void *vfgsio_writer_open(const char *path, size_t frame_bytes, int nbuf)
{
    int fd = open(path, O_WRONLY | O_CREAT | O_TRUNC, 0644);
    if (fd < 0) return NULL;
    vfgsio_ring *r = ring_new(fd, frame_bytes, nbuf);
    if (!r) { close(fd); return NULL; }
    pthread_create(&r->thread, NULL, writer_main, r);
    return r;
}

/* Queue one frame for writing (copies src).  Returns 1, or 0 on error. */
int vfgsio_writer_put(void *h, const uint8_t *src, size_t len)
{
    vfgsio_ring *r = h;
    if (r->eof) return 0;
    pthread_mutex_lock(&r->mu);
    while (r->count == r->nbuf)
        pthread_cond_wait(&r->can_put, &r->mu);
    int slot = r->head;
    pthread_mutex_unlock(&r->mu);

    memcpy(r->buf[slot], src, len);

    pthread_mutex_lock(&r->mu);
    r->fill[slot] = (ssize_t)len;
    r->head = (r->head + 1) % r->nbuf;
    r->count++;
    pthread_cond_signal(&r->can_get);
    pthread_mutex_unlock(&r->mu);
    return 1;
}

static void ring_close(vfgsio_ring *r, int drain)
{
    pthread_mutex_lock(&r->mu);
    if (drain)
        while (r->count > 0 && !r->eof)
            pthread_cond_wait(&r->can_put, &r->mu);
    r->stop = 1;
    pthread_cond_broadcast(&r->can_put);
    pthread_cond_broadcast(&r->can_get);
    pthread_mutex_unlock(&r->mu);
    pthread_join(r->thread, NULL);
    close(r->fd);
    for (int i = 0; i < r->nbuf; i++) free(r->buf[i]);
    free(r->buf);
    free(r->fill);
    free(r);
}

void vfgsio_reader_close(void *h) { ring_close(h, 0); }
void vfgsio_writer_close(void *h) { ring_close(h, 1); }
